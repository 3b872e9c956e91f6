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
// Design: the Pallas tiling keeps a [bt, D] f32 accumulator resident
// across a sequential F grid axis; that is ~9 MiB, it does not fit in a
// Hopper block's 227 KB of shared memory, and Hopper blocks run unordered
// so nothing can carry across them. So the FFN runs in two passes of one
// kernel, C = A B over each expert:
//   1. gate/up: A = x, B = Wg and Wu, epilogue h = silu(g) * u rounded to
//      x's dtype (the Pallas numerics), written to a scratch [E, T, F];
//   2. down: A = h, B = Wd, epilogue rounds the f32 sum to the output dtype.
// A block owns one expert, a tile of 8 rows and 128 output columns. Each
// lane streams its own 4 columns of B straight from HBM into registers
// (one 8-byte load per row of B in bf16, 16 bytes in f32: 256-512 byte
// runs per warp and row, four rows loaded ahead of their FMAs) and keeps
// the 8 rows' sums in registers, so every weight element is loaded once
// per row tile and used for 8 FMAs. The block's 8 rows of A are staged in
// shared memory as f32 [k][8], so one row of B meets its 8 x values in two
// broadcast 16-byte shared loads. The 8 warps split the reduction depth
// and add their partial sums up in shared memory at the end. With T <= 8
// (decode) the weights stream exactly once; larger T re-reads them once
// per 8-row tile. Any T, D and F. The tile constants were picked by timing
// variants on the card; wgmma/TMA pipelines are later work (see PERF.md).
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. h is an [E, T, F] scratch of that dtype.
// Returns cudaGetLastError() after the launches (0 on success).
int moe_gmm_launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* h, void* out, int e, int t, int d,
                   int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wg, wu, wd, h, out, e, t, d, f, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wg, wu, wd, h, out, e, t, d, f, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
