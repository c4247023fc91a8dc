// Row RMSNorm (optionally of x + residual), forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas (the TPU
// kernel, bodies `_kernel` and `_kernel_res`).  It computes the function of
// the plain version src/repro_torch/kernels/rmsnorm/ref.py:rmsnorm, for each
// of the (rows, d) rows of x:
//   v = x [+ residual]                      (in f32)
//   y = v * rsqrt(mean(v^2) + eps) * scale  (sum of squares in f32)
// cast to x's dtype.  The residual variant returns only y, not the sum.
//   x, residual (rows, d) in T (f32 or bf16, one dtype); scale (d,) in S
//   (f32, bf16 or f16, read as f32); y (rows, d) in T.
//
// What bounds it on this card: bytes.  The function reads x (and the
// residual) once and writes y once, about one FLOP per byte: at the
// `kernels` grid's r16384d1536 in bf16, 50.3 MB read + 50.3 MB written =
// 0.030 ms at 3.35 TB/s (0.045 ms with the residual); the 3 FLOPs per
// element are nothing at 67 TFLOP/s of f32.  So the design is about moving
// those bytes at the memory's rate and nothing more: every byte of x is
// loaded in 16-byte vectors by neighbouring threads on neighbouring
// addresses, the row's sum is formed in registers and warp shuffles, and
// the second pass that writes y re-reads the row while it is still in L1/L2
// (a row is at most a few KB), so device memory sees x once.
//
// Design.  The TPU kernel normalizes a (block_rows, d) tile in VMEM per
// grid step and halves block_rows until it divides rows.  Here ROW_THREADS
// threads (32, 64, 128 or 256) own one row: a strided pass over the row in
// 16-byte vectors where d * sizeof(T) % 16 == 0 and every pointer is
// 16-byte aligned, else in masked scalar loads; warp shuffles, then shared
// memory across the row's warps, give the sum; the second pass writes y.
// block_rows rows (a launch parameter: 1, 2, 4, 8 or 16) share one CUDA
// block of min(block_rows, 1024 / ROW_THREADS) row groups, each group
// taking every G-th of the block's rows; rows past the end of a ragged last
// block are masked (they still reach the block's barriers).  The scale is
// read with scalar loads: d values, hot in L1 for every row.
// Compiled: T f32 / bf16 x S f32 / bf16 / f16 x ROW_THREADS 32 / 64 / 128 /
// 256 = 24 instances.
//
// Entry point: repro_rmsnorm_fwd (plain C, called through ctypes); it
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as floats, and back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(in[2 * k], in[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <typename T, typename S, int RT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const S* __restrict__ scale, T* __restrict__ y, int rows, int d,
                   float eps, int block_rows, int vec) {
  constexpr int kWarps = RT / 32;
  constexpr int kV = Vec<T>::kN;
  __shared__ float red[kMaxThreads / 32];  // [group][warp of the row]

  const int groups = blockDim.x / RT;
  const int g = threadIdx.x / RT;
  const int lane = threadIdx.x % RT;
  const int warp = lane / 32;
  const float inv_d = 1.f / (float)d;
  const int row0 = blockIdx.x * block_rows;
  const int iters = (block_rows + groups - 1) / groups;

  for (int it = 0; it < iters; ++it) {
    const int rb = it * groups + g;                 // row within the block
    const int row = row0 + rb;
    const bool valid = rb < block_rows && row < rows;
    const size_t off = (size_t)(valid ? row : 0) * d;
    const T* xr = x + off;
    const T* rr = res != nullptr ? res + off : nullptr;

    // ---- pass 1: sum of squares in f32
    float ss = 0.f;
    if (valid) {
      if (vec) {
        for (int i = lane * kV; i < d; i += RT * kV) {
          float v[kV];
          Vec<T>::load(xr + i, v);
          if (rr != nullptr) {
            float r[kV];
            Vec<T>::load(rr + i, r);
#pragma unroll
            for (int k = 0; k < kV; ++k) v[k] += r[k];
          }
#pragma unroll
          for (int k = 0; k < kV; ++k) ss = fmaf(v[k], v[k], ss);
        }
      } else {
        for (int i = lane; i < d; i += RT) {
          float v = to_f32(xr[i]);
          if (rr != nullptr) v += to_f32(rr[i]);
          ss = fmaf(v, v, ss);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (kWarps > 1) {
      if ((lane & 31) == 0) red[g * kWarps + warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ss += red[g * kWarps + w];
      __syncthreads();  // red is rewritten by the next row
    }
    const float inv = rsqrtf(ss * inv_d + eps);

    // ---- pass 2: re-read the row (L1/L2) and write y
    if (!valid) continue;
    T* yr = y + off;
    if (vec) {
      for (int i = lane * kV; i < d; i += RT * kV) {
        float v[kV];
        Vec<T>::load(xr + i, v);
        if (rr != nullptr) {
          float r[kV];
          Vec<T>::load(rr + i, r);
#pragma unroll
          for (int k = 0; k < kV; ++k) v[k] += r[k];
        }
#pragma unroll
        for (int k = 0; k < kV; ++k) v[k] = v[k] * inv * to_f32(scale[i + k]);
        Vec<T>::store(yr + i, v);
      }
    } else {
      for (int i = lane; i < d; i += RT) {
        float v = to_f32(xr[i]);
        if (rr != nullptr) v += to_f32(rr[i]);
        yr[i] = from_f32(v * inv * to_f32(scale[i]), (T*)nullptr);
      }
    }
  }
}

template <typename T, typename S, int RT>
cudaError_t launch(const void* x, const void* res, const void* scale, void* y, int rows, int d,
                   float eps, int block_rows, int vec, cudaStream_t stream) {
  const int groups = block_rows < kMaxThreads / RT ? block_rows : kMaxThreads / RT;
  const int blocks = (rows + block_rows - 1) / block_rows;
  rmsnorm_fwd_kernel<T, S, RT><<<blocks, groups * RT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, d, eps, block_rows, vec);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch_rt(int row_threads, const void* x, const void* res, const void* scale,
                        void* y, int rows, int d, float eps, int block_rows, int vec,
                        cudaStream_t s) {
  switch (row_threads) {
    case 32: return launch<T, S, 32>(x, res, scale, y, rows, d, eps, block_rows, vec, s);
    case 64: return launch<T, S, 64>(x, res, scale, y, rows, d, eps, block_rows, vec, s);
    case 128: return launch<T, S, 128>(x, res, scale, y, rows, d, eps, block_rows, vec, s);
    case 256: return launch<T, S, 256>(x, res, scale, y, rows, d, eps, block_rows, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_s(int scale_dtype, int row_threads, const void* x, const void* res,
                       const void* scale, void* y, int rows, int d, float eps, int block_rows,
                       int vec, cudaStream_t s) {
  switch (scale_dtype) {
    case 0: return dispatch_rt<T, float>(row_threads, x, res, scale, y, rows, d, eps, block_rows, vec, s);
    case 1: return dispatch_rt<T, __nv_bfloat16>(row_threads, x, res, scale, y, rows, d, eps, block_rows, vec, s);
    case 2: return dispatch_rt<T, __half>(row_threads, x, res, scale, y, rows, d, eps, block_rows, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype (x, residual and y): 0 = float32, 1 = bfloat16.  scale_dtype: 0 =
// float32, 1 = bfloat16, 2 = float16.  residual may be null.  Tensors are
// contiguous; the Python wrapper checks shapes, dtypes and contiguity.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* residual, const void* scale, void* y,
                                 int dtype, int scale_dtype, int rows, int d, float eps,
                                 int block_rows, int row_threads, void* stream) {
  if (rows <= 0 || d <= 0 || block_rows <= 0 || block_rows > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = ((size_t)d * elem) % 16 == 0 && aligned16(x) && aligned16(residual) &&
                  aligned16(y);
  if (dtype == 0)
    return (int)dispatch_s<float>(scale_dtype, row_threads, x, residual, scale, y, rows, d, eps, block_rows, vec, s);
  if (dtype == 1)
    return (int)dispatch_s<__nv_bfloat16>(scale_dtype, row_threads, x, residual, scale, y, rows, d, eps, block_rows, vec, s);
  return (int)cudaErrorInvalidValue;
}
