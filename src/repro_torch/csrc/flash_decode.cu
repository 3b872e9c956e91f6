// One-token GQA decode attention over a KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas, body _kernel): q [B, H, hd] against k/v
// [B, KH, S, hd] with g = H / KH query heads per KV head, scores scaled by
// hd^-0.5, positions >= length masked, online softmax (m, l, acc) in f32,
// normalised output [B, H, hd] in q's dtype.
//
// What bounds it on this card: every valid K and V row is read once,
// 2*B*KH*len*hd elements, against ~4*B*H*len*hd flops: bytes bound it. At
// olmoe's decode shapes (B=8, KH=16, hd=128, len ~200) that is ~13 MB, a
// few microseconds at 3.35 TB/s, so launch latency dominates.
//
// Design: the Pallas grid walks S tiles in order and carries (m, l, acc)
// in VMEM scratch across grid steps; Hopper blocks run unordered and carry
// nothing, so one block per (b, kv-head) loops over the S tiles itself and
// keeps the state of its g query heads in shared memory. It stops at its
// own slot's length, lengths[b] (an int32 [B] device tensor: the engine's
// slots decode at different positions), so no block reads past its
// cache's valid rows, and it masks the ragged last tile itself: any S.
// Per tile of 64 positions: each warp takes whole K rows (coalesced) and
// reduces the dot products with shuffles; one warp per head updates m and
// l; then each thread owns a dimension of acc and streams V rows. Splitting
// S across blocks (flash-decoding) is later work: at B=8, KH=16 there are
// already 128 blocks for 132 SMs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BS = 64;          // positions per tile
constexpr int NT = 128;         // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr int MAX_HD = 256;     // head dim limit (8 values per lane)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int kh, int g, int s, int hd,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // [g, hd]
  float* acc = qs + g * hd;       // [g, hd]
  float* ps = acc + g * hd;       // [g, BS] scores, then probabilities
  float* ms = ps + g * BS;        // [g] running max
  float* ls = ms + g;             // [g] running sum
  float* cs = ls + g;             // [g] correction of this tile

  const int b = blockIdx.x / kh;
  const int h = blockIdx.x % kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], s);
  const size_t qoff = ((size_t)b * kh + h) * (size_t)g * hd;
  const size_t kvoff = ((size_t)b * kh + h) * (size_t)s * hd;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;

  for (int i = tid; i < g * hd; i += NT) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += NT) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < len; s0 += BS) {
    // 1. scores: a warp per K row, dot products reduced with shuffles
    for (int j = warp; j < BS; j += NW) {
      const int pos = s0 + j;
      if (pos < len) {
        const T* kr = kb + (size_t)pos * hd;
        float kreg[MAX_HD / 32];
#pragma unroll
        for (int i = 0; i < MAX_HD / 32; ++i) {
          const int d = lane + 32 * i;
          kreg[i] = d < hd ? to_f(kr[d]) : 0.f;
        }
        for (int gi = 0; gi < g; ++gi) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < MAX_HD / 32; ++i) {
            const int d = lane + 32 * i;
            if (d < hd) part += qs[gi * hd + d] * kreg[i];
          }
          part = warp_sum(part);
          if (lane == 0) ps[gi * BS + j] = part * scale;
        }
      } else {
        for (int gi = lane; gi < g; gi += 32) ps[gi * BS + j] = NEG_INF;
      }
    }
    __syncthreads();

    // 2. online softmax: a warp per query head
    for (int gi = warp; gi < g; gi += NW) {
      float mx = NEG_INF;
      for (int j = lane; j < BS; j += 32) mx = fmaxf(mx, ps[gi * BS + j]);
      mx = warp_max(mx);
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BS; j += 32) {
        const float p = (s0 + j < len) ? expf(ps[gi * BS + j] - m_new) : 0.f;
        ps[gi * BS + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        ls[gi] = ls[gi] * corr + sum;
        ms[gi] = m_new;
        cs[gi] = corr;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p V: a thread per head dimension, V rows coalesced
    const int n_here = min(BS, len - s0);
    for (int d = tid; d < hd; d += NT) {
      for (int gi = 0; gi < g; ++gi) acc[gi * hd + d] *= cs[gi];
      for (int j = 0; j < n_here; ++j) {
        const float vv = to_f(vb[(size_t)(s0 + j) * hd + d]);
        for (int gi = 0; gi < g; ++gi) acc[gi * hd + d] += ps[gi * BS + j] * vv;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < g * hd; i += NT) {
    out[qoff + i] = from_f<T>(acc[i] / fmaxf(ls[i / hd], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int b, int kh, int g, int s, int hd, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)2 * g * hd + (size_t)g * BS + 3 * g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  flash_decode_kernel<T><<<b * kh, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), kh, g, s, hd,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lengths: int32 [B] on the device.
// Returns cudaGetLastError() after the launch (0 on success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, int b, int kh, int g,
                        int s, int hd, int dtype, void* stream) {
  if (hd > MAX_HD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0) return launch<float>(q, k, v, len, out, b, kh, g, s, hd, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, len, out, b, kh, g, s, hd, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
