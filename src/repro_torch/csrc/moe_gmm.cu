// Grouped expert SwiGLU FFN over the static-capacity buffer, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py
// (moe_gmm_pallas, body _kernel):
//   out[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e]
//   x [E, T, D]; Wg/Wu [E, D, F]; Wd [E, F, D] -> out [E, T, D]
// with g and u accumulated in f32, h rounded to x's dtype, and the
// down-projection accumulated in f32 and rounded to the output dtype.
//
// What bounds it on this card: at decode T is a few rows per expert
// (8 slots x capacity 1 on olmoe-1b-7b), so the work is a weight stream:
// every expert's three matrices are read once (3*E*D*F elements, ~805 MB
// in bf16 for olmoe, ~0.24 ms at 3.35 TB/s), against ~6*E*T*D*F flops,
// far below the tensor-core line. Bytes bound it.
//
// Both variants run the FFN in two passes. The Pallas tiling keeps a
// [bt, D] f32 accumulator resident across a sequential F grid axis; that is
// ~9 MiB, it does not fit in a Hopper block's 227 KB of shared memory, and
// Hopper blocks run unordered so nothing can carry across them. So:
//   1. gate/up: A = x, B = Wg and Wu, epilogue h = silu(g) * u rounded to
//      x's dtype (the Pallas numerics), written to a scratch [E, T, F];
//   2. down: A = h, B = Wd, epilogue rounds the f32 sum to the output dtype.
//
// Tensor-core variant (bf16, D and F multiples of 8; moe_gmm_tc_kernel):
// the product is swapped, out^T = W^T x^T, so the weights are the MMA's M
// rows and the tokens its N columns. A block owns one expert, a tile of MT
// weight columns (F for gate/up, D for down) and N = 8*NF tokens, with N
// the padded T up to 256: every weight element is read from HBM once for
// any T <= 256 (decode is T = 8, a 128-token prefill T = 24). The depth
// streams through a ring of STAGES stages in shared memory, each filled by
// 16-byte cp.async copies issued STAGES-1 stages ahead (48 KB in flight
// per block at MT = 128): two [32, MT] weight panels and the x (or h)
// chunk beside them, rows padded by 16 bytes so that ldmatrix is free of
// bank conflicts. The products are mma.sync m16n8k16 (bf16 in, f32 sums):
// ldmatrix.trans turns the [k, m] weight panel into the row-major A
// fragment, and ldmatrix reads x's [n, k] rows as the column-major B
// fragment. The 8 warps form two groups of 4: in the gated pass group j
// takes panel j (gate or up) and in the down pass the two k-halves of each
// stage; each warp owns MT/4 columns. The accumulators are small (NF*4
// floats per m16 tile), so after the loop the second group hands its sums
// to the first through shared memory, which applies silu(g)*u or adds,
// rounds to bf16 and stores with T's padded rows masked.
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
// tensor-core variant, bf16: out^T = W^T x^T through mma.sync m16n8k16
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NWARP = 8;          // two groups of four warps
constexpr int NTHR = 32 * NWARP;
constexpr int KP = 32;            // depth of one weight panel: two k16 steps
constexpr int STAGES = 4;         // ring depth; STAGES-1 stages in flight
constexpr int PAD = 8;            // bf16 (16 bytes) of padding per smem row

template <bool GATED, int MT, int NF>
struct Tile {
  static_assert(MT % 64 == 0, "each of 4 warps owns whole m16 tiles");
  static constexpr int N = 8 * NF;                   // tokens per block
  static constexpr int MI = MT / 64;                 // m16 tiles per warp
  static constexpr int KSTEP = GATED ? KP : 2 * KP;  // depth per stage
  static constexpr int WPITCH = MT + PAD;            // weight panel row
  static constexpr int XPITCH = KSTEP + PAD;         // x row
  static constexpr int PANEL = KP * WPITCH;          // elements
  static constexpr int STAGE = 2 * PANEL + N * XPITCH;
  static constexpr int RING_BYTES = STAGES * STAGE * 2;
  static constexpr int RED_BYTES = 4 * MI * NF * 4 * 32 * 4;  // group 1's sums
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; zeros when !valid (src is not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[e] (t x m) = A[e] (t x k) W0[e] (k x m) [and W1[e]], all row-major;
// GATED: C = bf16(silu(A W0) * (A W1)), else C = bf16(A W0).
template <bool GATED, int MT, int NF>
__global__ void __launch_bounds__(NTHR)
moe_gmm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w0,
                  const bf16* __restrict__ w1, bf16* __restrict__ c, int t,
                  int k, int m) {
  using TL = Tile<GATED, MT, NF>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * TL::N, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wig = warp & 3;
  const bf16* ae = a + (size_t)e * t * k;
  const bf16* we0 = w0 + (size_t)e * k * m;
  const bf16* we1 = GATED ? w1 + (size_t)e * k * m : we0;
  const int nk = (k + TL::KSTEP - 1) / TL::KSTEP;

  // stage kt: panel p holds weight rows [k0, k0 + KP) of matrix p (gated)
  // or rows [k0 + p*KP, k0 + (p+1)*KP) of the one matrix; then the x chunk.
  auto load_stage = [&](int slot, int kt) {
    bf16* st = ring + slot * TL::STAGE;
    const int k0 = kt * TL::KSTEP;
    constexpr int CPR = MT / 8;                      // 16-byte pieces per row
    for (int i = tid; i < 2 * KP * CPR; i += NTHR) {
      const int p = i / (KP * CPR), r = (i / CPR) % KP, cc = (i % CPR) * 8;
      const int kk = k0 + (GATED ? 0 : p * KP) + r, col = m0 + cc;
      const bool ok = kk < k && col < m;
      const bf16* wp = p ? we1 : we0;
      cp16(st + p * TL::PANEL + r * TL::WPITCH + cc,
           ok ? wp + (size_t)kk * m + col : we0, ok);
    }
    constexpr int XPR = TL::KSTEP / 8;
    bf16* xs = st + 2 * TL::PANEL;
    for (int i = tid; i < TL::N * XPR; i += NTHR) {
      const int n = i / XPR, cc = (i % XPR) * 8;
      const int tok = n0 + n, kk = k0 + cc;
      const bool ok = tok < t && kk < k;
      cp16(xs + n * TL::XPITCH + cc, ok ? ae + (size_t)tok * k + kk : ae, ok);
    }
  };

  float acc[TL::MI][NF][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // group grp reads panel grp; in the down pass its x columns follow it
  auto compute_stage = [&](int slot) {
    const bf16* st = ring + slot * TL::STAGE;
    const bf16* panel = st + grp * TL::PANEL;
    const bf16* xs = st + 2 * TL::PANEL + (GATED ? 0 : grp * KP);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned af[TL::MI][4];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi) {
        const int q = lane >> 3, r = lane & 7;       // matrix q, its row r
        ldsm_x4_trans(af[mi], panel + (ks * 16 + (q >> 1) * 8 + r) * TL::WPITCH
                                  + wig * (MT / 4) + mi * 16 + (q & 1) * 8);
      }
#pragma unroll
      for (int ni = 0; ni < NF; ++ni) {
        unsigned bfr[2];
        ldsm_x2(bfr, xs + (ni * 8 + (lane & 7)) * TL::XPITCH + ks * 16
                         + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < TL::MI; ++mi) mma16816(acc[mi][ni], af[mi], bfr);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();                     // stage kt has landed
    __syncthreads();                                 // and slot kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    compute_stage(kt % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();                                   // the ring is free

  // group 1 hands its sums (up, or the second k-half) to group 0
  float* red = reinterpret_cast<float*>(smem_raw);
  if (grp == 1) {
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[(((wig * TL::MI + mi) * NF + ni) * 4 + r) * 32 + lane] = acc[mi][ni][r];
  }
  __syncthreads();
  if (grp == 1) return;
  bf16* ce = c + (size_t)e * t * m;
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v0 = acc[mi][ni][r];
        const float v1 = red[(((wig * TL::MI + mi) * NF + ni) * 4 + r) * 32 + lane];
        const float out = GATED ? v0 / (1.f + expf(-v0)) * v1 : v0 + v1;
        const int col = m0 + wig * (MT / 4) + mi * 16 + (lane >> 2) + (r >> 1) * 8;
        const int tok = n0 + ni * 8 + (lane & 3) * 2 + (r & 1);
        if (col < m && tok < t) ce[(size_t)tok * m + col] = __float2bfloat16(out);
      }
}

template <bool GATED, int MT, int NF>
int launch_pass(const bf16* a, const bf16* w0, const bf16* w1, bf16* c, int e,
                int t, int k, int m, cudaStream_t s) {
  using TL = Tile<GATED, MT, NF>;
  cudaError_t err = cudaFuncSetAttribute(moe_gmm_tc_kernel<GATED, MT, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + MT - 1) / MT, (t + TL::N - 1) / TL::N, e);
  moe_gmm_tc_kernel<GATED, MT, NF><<<grid, NTHR, TL::SMEM, s>>>(a, w0, w1, c, t, k, m);
  return cudaGetLastError();
}

template <int MT, int NF>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* h, void* out, int e, int t, int d, int f, cudaStream_t s) {
  const int err = launch_pass<true, MT, NF>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<bf16*>(h), e, t, d, f, s);
  if (err != cudaSuccess) return err;
  return launch_pass<false, MT, NF>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(wd), static_cast<bf16*>(out), e, t, f, d, s);
}

// (nf, mt) as the wrapper's tile plan gives them
int launch_plan(int nf, int mt, const void* x, const void* wg, const void* wu,
                const void* wd, void* h, void* out, int e, int t, int d, int f,
                cudaStream_t s) {
  if (mt == 128) {
    switch (nf) {
      case 1: return launch<128, 1>(x, wg, wu, wd, h, out, e, t, d, f, s);
      case 2: return launch<128, 2>(x, wg, wu, wd, h, out, e, t, d, f, s);
      case 4: return launch<128, 4>(x, wg, wu, wd, h, out, e, t, d, f, s);
      case 8: return launch<128, 8>(x, wg, wu, wd, h, out, e, t, d, f, s);
      case 16: return launch<128, 16>(x, wg, wu, wd, h, out, e, t, d, f, s);
    }
  }
  if (mt == 64 && nf == 32) return launch<64, 32>(x, wg, wu, wd, h, out, e, t, d, f, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

struct KernelEntry {
  const char* name;
  const void* fn;
};

#define TC_ENTRIES(MT, NF)                                                   \
  {"moe_gmm_tc<gated," #MT "," #NF ">", (const void*)tc::moe_gmm_tc_kernel<true, MT, NF>}, \
  {"moe_gmm_tc<down," #MT "," #NF ">", (const void*)tc::moe_gmm_tc_kernel<false, MT, NF>}

const KernelEntry kKernels[] = {
    {"moe_gemm<f32,gated>", (const void*)moe_gemm_kernel<float, true>},
    {"moe_gemm<f32,down>", (const void*)moe_gemm_kernel<float, false>},
    {"moe_gemm<bf16,gated>", (const void*)moe_gemm_kernel<__nv_bfloat16, true>},
    {"moe_gemm<bf16,down>", (const void*)moe_gemm_kernel<__nv_bfloat16, false>},
    TC_ENTRIES(128, 1), TC_ENTRIES(128, 2), TC_ENTRIES(128, 4),
    TC_ENTRIES(128, 8), TC_ENTRIES(128, 16), TC_ENTRIES(64, 32),
};
#undef TC_ENTRIES

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
// pointer 16-byte aligned; (nf, mt) is the wrapper's tile plan for T.
int moe_gmm_tc_launch(const void* x, const void* wg, const void* wu,
                      const void* wd, void* h, void* out, int e, int t, int d,
                      int f, int nf, int mt, void* stream) {
  if (d % 8 || f % 8) return cudaErrorInvalidValue;
  return tc::launch_plan(nf, mt, x, wg, wu, wd, h, out, e, t, d, f,
                         static_cast<cudaStream_t>(stream));
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
