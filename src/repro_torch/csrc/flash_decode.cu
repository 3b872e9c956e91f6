// One-token GQA decode attention over a KV cache, for Hopper: flash-decoding
// with the cache split over S.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas, body _kernel): q [B, H, hd] against k/v
// [B, KH, S, hd] with g = H / KH query heads per KV head, scores scaled by
// hd^-0.5, positions >= length masked, softmax in f32, normalised output
// [B, H, hd] in q's dtype.
//
// What bounds it on this card: every valid K and V row is read once,
// 2*B*KH*len*hd elements, against ~4*B*H*len*hd flops, so bytes bound it.
// At olmoe's decode shapes (B=8, KH=16, hd=128, len <= 160) that is ~7 MB,
// about 2 us at 3.35 TB/s, so the real floor is the latency of one round
// trip to HBM plus the launch of two small kernels: a few microseconds.
//
// Design: the Pallas grid walks S tiles in order and carries (m, l, acc) in
// VMEM scratch from one grid step to the next. Hopper blocks run unordered,
// and one block walking its tiles in series puts one HBM latency per tile
// on the critical path. So the work is split over S in two launches:
//   1. partials, grid (B*KH, n_split), n_split = ceil(S / CHUNK) from the
//      cache capacity alone (CHUNK = 64: 128 timed the same on the card,
//      and 64 also fits f32 at hd 256 in shared memory) (no host read of the lengths, so the call stays
//      asynchronous). A block whose chunk starts at or past its slot's
//      length writes an empty partial (m = -inf, l = 0) and returns. Every
//      other block issues all of its chunk's K and V rows at once as 16-byte
//      cp.async copies into shared memory, computes the g x CHUNK scores in
//      f32 while V is still in flight (a thread per score, 16-byte shared
//      reads of the K row), masks the ragged end, takes the chunk's max m
//      and sum l (a warp per query head), and writes the unnormalised
//      o = sum_j p_j V_j (a thread per output element) with m and l to an
//      f32 scratch [B, KH, n_split, g, hd | 1].
//   2. combine, a block per (slot, query head): the lse-combine of the
//      slot's valid splits, o = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c,
//      written in q's dtype. A slot of length 0 gets zeros. It is launched
//      as a programmatic dependent of pass 1, so its blocks are resident
//      and waiting (griddepcontrol.wait) when pass 1 ends, instead of
//      paying a second launch latency after it.
// Any g, hd <= 256, any S; rows whose bytes are not a multiple of 16 are
// copied element by element instead.
//
// The (o, m, l) form (flash_decode_lse_launch) serves a decode whose KV
// cache is sequence-sharded over ranks, where JAX calls the plain
// attn_chunk_lse (src/repro/models/layers/attention.py:114) and merges the
// ranks' partials with lse_combine. Pass 1 is the same; pass 2 keeps the
// shard's unnormalised o = sum_c e^(m_c - M) o_c (f32 [B, H, hd]), its max
// M and its sum L = sum_c e^(m_c - M) l_c (f32 [B, H]). A shard with
// nothing to attend to (length 0) writes o = 0, l = 0 and m = -1e30, the
// reference's NEG_INF and not -inf, so that the cross-rank combine never
// takes -inf - (-inf). It adds 8 bytes of m and l per (slot, head) to the
// normalised form's traffic, and writes o in f32.
#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 128;         // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr int MAX_HD = 256;     // head dim limit
constexpr int CHUNK = 64;       // cache positions per split
constexpr float NEG_INF = -1e30f;   // the plain version's mask value

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Elements of T in 16 bytes, and the shared-memory row of a K or V row:
// hd padded by 16 bytes so that rows start in different banks.
template <typename T> __host__ __device__ constexpr int epv() { return 16 / sizeof(T); }
__host__ __device__ inline int row_pitch(int hd, int elem_bytes) {
  return hd + 16 / elem_bytes;
}

template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows, int hd,
                                          int pitch, bool vec) {
  if (vec) {
    const int vpr = hd / epv<T>();                    // 16-byte pieces per row
    for (int i = threadIdx.x; i < rows * vpr; i += NT) {
      const int r = i / vpr, c = (i % vpr) * epv<T>();
      cp_async16(dst + r * pitch + c, src + (size_t)r * hd + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += NT)
      dst[(i / hd) * pitch + i % hd] = src[i];
  }
}

// Dot product of a query head (f32, shared) with a K row (T, shared).
template <typename T>
__device__ __forceinline__ float dot_row(const float* qh, const T* kr, int hd, bool vec) {
  float acc = 0.f;
  if (vec) {
    for (int c = 0; c < hd; c += epv<T>()) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
      const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < epv<T>(); ++i) acc += qh[c + i] * to_f(kv[i]);
    }
  } else {
    for (int d = 0; d < hd; ++d) acc += qh[d] * to_f(kr[d]);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ lengths,
                            float* __restrict__ o_part, float* __restrict__ m_part,
                            float* __restrict__ l_part, int kh, int g, int s,
                            int hd, int n_split, float scale) {
  // let the combine's blocks be scheduled now; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int bh = blockIdx.x;                       // b * kh + kv head
  const int c = blockIdx.y;                        // split
  const int len = min(max(lengths[bh / kh], 0), s);
  const int start = c * CHUNK;
  const size_t part = (size_t)bh * n_split + c;    // [B, KH, n_split]
  float* mp = m_part + part * g;
  float* lp = l_part + part * g;
  if (start >= len) {
    for (int i = threadIdx.x; i < g; i += NT) {
      mp[i] = -INFINITY;
      lp[i] = 0.f;
    }
    return;
  }
  const int rows = min(CHUNK, len - start);
  const int pitch = row_pitch(hd, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);          // [CHUNK, pitch]
  T* vs = ks + CHUNK * pitch;                      // [CHUNK, pitch]
  float* qs = reinterpret_cast<float*>(vs + CHUNK * pitch);   // [g, hd]
  float* ps = qs + g * hd;                         // [g, CHUNK]

  const bool vec = (hd * sizeof(T)) % 16 == 0;
  const size_t kvoff = ((size_t)bh * s + start) * hd;
  load_rows(ks, k + kvoff, rows, hd, pitch, vec);
  cp_async_commit();
  load_rows(vs, v + kvoff, rows, hd, pitch, vec);
  cp_async_commit();
  const T* qb = q + (size_t)bh * g * hd;
  for (int i = threadIdx.x; i < g * hd; i += NT) qs[i] = to_f(qb[i]);
  cp_async_wait<1>();                              // K has landed, V may not
  __syncthreads();

  // 1. scores, a thread per (query head, position)
  for (int i = threadIdx.x; i < g * CHUNK; i += NT) {
    const int gi = i / CHUNK, j = i % CHUNK;
    ps[i] = j < rows ? dot_row(qs + gi * hd, ks + j * pitch, hd, vec) * scale
                     : -INFINITY;
  }
  __syncthreads();

  // 2. the chunk's max and sum, a warp per query head
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int gi = warp; gi < g; gi += NW) {
    float* p = ps + gi * CHUNK;
    float mx = -INFINITY;
    for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, p[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < rows; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      mp[gi] = mx;
      lp[gi] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. unnormalised o = p V, a thread per (query head, dimension)
  float* op = o_part + part * g * hd;
  for (int i = threadIdx.x; i < g * hd; i += NT) {
    const int gi = i / hd, d = i % hd;
    const float* p = ps + gi * CHUNK;
    float acc = 0.f;
    for (int j = 0; j < rows; ++j) acc += p[j] * to_f(vs[j * pitch + d]);
    op[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_combine_kernel(const float* __restrict__ o_part,
                            const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            const int* __restrict__ lengths, T* __restrict__ out,
                            int kh, int g, int s, int hd, int n_split) {
  // launched early (programmatic dependent launch): wait here until the
  // partials' grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bhg = blockIdx.x;                      // (b * kh + kv head) * g + gi
  const int bh = bhg / g, gi = bhg % g;
  const int len = min(max(lengths[bh / kh], 0), s);
  const int n_valid = (len + CHUNK - 1) / CHUNK;
  const size_t base = (size_t)bh * n_split;
  float mx = -INFINITY;
  for (int c = 0; c < n_valid; ++c) mx = fmaxf(mx, m_part[(base + c) * g + gi]);
  float den = 0.f;
  for (int c = 0; c < n_valid; ++c)
    den += expf(m_part[(base + c) * g + gi] - mx) * l_part[(base + c) * g + gi];
  const float inv = n_valid ? 1.f / den : 0.f;
  for (int d = threadIdx.x; d < hd; d += NT) {
    float acc = 0.f;
    for (int c = 0; c < n_valid; ++c)
      acc += expf(m_part[(base + c) * g + gi] - mx) *
             o_part[((base + c) * g + gi) * hd + d];
    out[(size_t)bhg * hd + d] = from_f<T>(acc * inv);
  }
}

// The (o, m, l) combine: a block per (slot, query head), as above, but the
// output stays unnormalised and f32, with its max and sum beside it.
__global__ void __launch_bounds__(NT)
flash_decode_combine_lse_kernel(const float* __restrict__ o_part,
                                const float* __restrict__ m_part,
                                const float* __restrict__ l_part,
                                const int* __restrict__ lengths,
                                float* __restrict__ o_out, float* __restrict__ m_out,
                                float* __restrict__ l_out, int kh, int g, int s,
                                int hd, int n_split) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bhg = blockIdx.x;                      // (b * kh + kv head) * g + gi
  const int bh = bhg / g, gi = bhg % g;
  const int len = min(max(lengths[bh / kh], 0), s);
  const int n_valid = (len + CHUNK - 1) / CHUNK;
  const size_t base = (size_t)bh * n_split;
  float mx = -INFINITY;
  for (int c = 0; c < n_valid; ++c) mx = fmaxf(mx, m_part[(base + c) * g + gi]);
  float den = 0.f;
  for (int c = 0; c < n_valid; ++c)
    den += expf(m_part[(base + c) * g + gi] - mx) * l_part[(base + c) * g + gi];
  if (threadIdx.x == 0) {
    m_out[bhg] = n_valid ? mx : NEG_INF;
    l_out[bhg] = den;
  }
  for (int d = threadIdx.x; d < hd; d += NT) {
    float acc = 0.f;
    for (int c = 0; c < n_valid; ++c)
      acc += expf(m_part[(base + c) * g + gi] - mx) *
             o_part[((base + c) * g + gi) * hd + d];
    o_out[(size_t)bhg * hd + d] = acc;
  }
}

template <typename T>
size_t partial_smem(int g, int hd) {
  return sizeof(T) * 2 * (size_t)CHUNK * row_pitch(hd, sizeof(T))
         + sizeof(float) * ((size_t)g * hd + (size_t)g * CHUNK);
}

template <typename T>
int launch_partials(const void* q, const void* k, const void* v, const int* lengths,
                    float* o_part, float* m_part, float* l_part, int b, int kh,
                    int g, int s, int hd, cudaStream_t st) {
  const size_t smem = partial_smem<T>(g, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_split = (s + CHUNK - 1) / CHUNK;
  const float scale = 1.0f / sqrtf((float)hd);
  flash_decode_partial_kernel<T><<<dim3(b * kh, n_split), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, o_part, m_part, l_part, kh, g, s, hd, n_split, scale);
  return cudaGetLastError();
}

// A combine of b * kh * g blocks, launched as a programmatic dependent of
// the partials: it may launch while they run (it waits for them), so its
// launch latency hides behind their tail.
template <typename... Params, typename... Args>
int launch_combine(void (*kernel)(Params...), int blocks, cudaStream_t st,
                   Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* o_part, float* m_part, float* l_part, int b,
           int kh, int g, int s, int hd, cudaStream_t st) {
  const int err = launch_partials<T>(q, k, v, lengths, o_part, m_part, l_part,
                                     b, kh, g, s, hd, st);
  if (err != cudaSuccess) return err;
  return launch_combine(flash_decode_combine_kernel<T>, b * kh * g, st,
                        (const float*)o_part, (const float*)m_part,
                        (const float*)l_part, lengths, static_cast<T*>(out),
                        kh, g, s, hd, (s + CHUNK - 1) / CHUNK);
}

template <typename T>
int launch_lse(const void* q, const void* k, const void* v, const int* lengths,
               float* o_out, float* m_out, float* l_out, float* o_part,
               float* m_part, float* l_part, int b, int kh, int g, int s, int hd,
               cudaStream_t st) {
  const int err = launch_partials<T>(q, k, v, lengths, o_part, m_part, l_part,
                                     b, kh, g, s, hd, st);
  if (err != cudaSuccess) return err;
  return launch_combine(flash_decode_combine_lse_kernel, b * kh * g, st,
                        (const float*)o_part, (const float*)m_part,
                        (const float*)l_part, lengths, o_out, m_out, l_out,
                        kh, g, s, hd, (s + CHUNK - 1) / CHUNK);
}

struct KernelEntry {
  const char* name;
  const void* fn;
};

const KernelEntry kKernels[] = {
    {"flash_decode_partial<f32>", (const void*)flash_decode_partial_kernel<float>},
    {"flash_decode_partial<bf16>", (const void*)flash_decode_partial_kernel<__nv_bfloat16>},
    {"flash_decode_combine<f32>", (const void*)flash_decode_combine_kernel<float>},
    {"flash_decode_combine<bf16>", (const void*)flash_decode_combine_kernel<__nv_bfloat16>},
    {"flash_decode_combine_lse", (const void*)flash_decode_combine_lse_kernel},
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lengths: int32 [B] on the device.
// o_part, m_part, l_part: f32 scratch [B, KH, ceil(S / 64), g, hd | 1 | 1].
// k and v start on a 16-byte boundary. Returns cudaGetLastError() after the
// two launches (0 on success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* o_part,
                        void* m_part, void* l_part, int b, int kh, int g,
                        int s, int hd, int dtype, void* stream) {
  if (hd > MAX_HD || hd <= 0 || s <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (dtype == 0)
    return launch<float>(q, k, v, len, out, op, mp, lp, b, kh, g, s, hd, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, len, out, op, mp, lp, b, kh, g, s, hd, st);
  return cudaErrorInvalidValue;
}

// The (o, m, l) form: the same arguments, and o_out f32 [B, H, hd], m_out
// and l_out f32 [B, H] in place of out.
int flash_decode_lse_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* o_out, void* m_out,
                            void* l_out, void* o_part, void* m_part, void* l_part,
                            int b, int kh, int g, int s, int hd, int dtype,
                            void* stream) {
  if (hd > MAX_HD || hd <= 0 || s <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* oo = static_cast<float*>(o_out);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (dtype == 0)
    return launch_lse<float>(q, k, v, len, oo, mo, lo, op, mp, lp, b, kh, g, s, hd, st);
  if (dtype == 1)
    return launch_lse<__nv_bfloat16>(q, k, v, len, oo, mo, lo, op, mp, lp, b, kh, g,
                                     s, hd, st);
  return cudaErrorInvalidValue;
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
