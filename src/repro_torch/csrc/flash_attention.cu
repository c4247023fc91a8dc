// Blocked attention forward with online softmax, for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (the TPU kernel, body `_kernel`) for float32 q, k, v; bfloat16 goes to the
// tensor-core kernel of flash_attention_tc.cu.  The Python wrapper picks the
// library by dtype and this one takes float32 only, so a bfloat16 call never
// reaches it.  It stays on exact f32 FMAs because the float32 checks (the
// 170*eps tolerance, the reduced models on the card against the CPU) need
// full f32 products, which TF32 tensor cores would break.  Same function:
// q (B,Sq,H,D) against k, v (B,Sk,K,D), GQA head h -> KV head h / (H/K),
// causal and sliding-window masks on absolute positions shifted by q_offset,
// masked scores -1e30, f32 running max m / sum l / accumulator, l clamped at
// 1e-30, output in float32.
//
// What bounds it on this card: at OLMo-1B's prefill shapes (B=1, H=K=16,
// D=128, S up to 1024) the function must move q, k, v and o once (33.6 MB
// in f32 at S=1024, 10.0 us at 3.35 TB/s) and do 4*D FLOPs per causal
// (q, k) pair (4.3 GFLOP at S=1024, 64 us at the 67 TFLOP/s of f32 FMAs):
// operations.
//
// Design.  The TPU kernel walks KV blocks on a sequential 4th grid axis and
// carries (acc, m, l) in VMEM scratch.  Here that axis is a loop inside one
// CUDA block: one block owns one (b, h, q-tile), stages K/V tiles through
// shared memory, and keeps m, l and the accumulator in f32 registers, so q
// is read once, o is written once, and nothing but K/V tiles moves between
// iterations (they hit L2 for the other q-tiles of the same head).  KV tiles
// wholly masked by the causal or window bound are never loaded, and the
// ragged edges (Sq, Sk not multiples of the tiles) are masked in the kernel.
// Scores and PV products are plain f32 FMAs over shared memory, bound by
// shared-memory bandwidth.
//
// Thread layout: BQ*4 threads = (BQ/4 row groups) x 16 lanes.  Lane tx of row
// group ty owns q rows 4ty..4ty+3, score columns tx + 16j and output columns
// tx + 16c; a row's max and sum reduce over its 16 lanes with shuffles.
//
// Tiles: block_q, block_kv in {64, 128}, each instance compiled where its
// shared memory fits a block's 227 KB (128/128 at D=128 needs 264 KB and is
// not); repro_flash_attention_smem_bytes gives -1 for the others.
//
// Entry points (plain C, called through ctypes): repro_flash_attention_fwd
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory one block may use on Hopper

template <typename T, int BQ, int BKV, int D>
struct Tile {
  static constexpr int kThreads = BQ * 4;
  static constexpr int kScoreCols = BKV / 16;        // score columns per lane
  static constexpr int kOutCols = D / 16;            // output columns per lane
  static constexpr int kPad = sizeof(T) == 4 ? 1 : 2;  // odd 32-bit word stride per row
  static constexpr int kLd = D + kPad;               // q / k row stride in shared memory
  static constexpr int kLdP = BKV + 1;               // p row stride
  static constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte global load
  static constexpr size_t kSmem =
      (size_t)(BQ * kLd + BKV * kLd + BKV * D) * sizeof(T) + (size_t)BQ * kLdP * sizeof(float);
};

// Copy `rows` rows (of `max_rows`) of D elements, global row stride `stride`,
// into shared memory with row stride `ld`; rows past `rows` become zeros so
// that masked lanes multiply zeros, never stale or NaN data.
template <typename T, int D, int kVec, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, size_t stride,
                                          int rows, int max_rows) {
  for (int c = threadIdx.x; c < max_rows * (D / kVec); c += kThreads) {
    const int r = c / (D / kVec);
    const int d0 = (c % (D / kVec)) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) raw = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + d0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * ld + d0 + i] = e[i];
  }
}

template <typename T, int BQ, int BKV, int D>
__global__ void __launch_bounds__(BQ * 4)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                           int n_heads, int n_kv, int causal, int window, int q_offset,
                           float scale) {
  using L = Tile<T, BQ, BKV, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * L::kLd;
  T* vs = ks + BKV * L::kLd;
  float* ps = reinterpret_cast<float*>(vs + BKV * D);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // Heaviest causal q-tiles (the last ones) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q_rows = min(BQ, sq - q0);
  const size_t q_stride = (size_t)n_heads * D;
  const size_t kv_stride = (size_t)n_kv * D;
  const T* q_base = q + ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
  const T* k_base = k + (size_t)b * sk * kv_stride + (size_t)kh * D;
  const T* v_base = v + (size_t)b * sk * kv_stride + (size_t)kh * D;

  load_rows<T, D, L::kVec, L::kThreads>(qs, L::kLd, q_base, q_stride, q_rows, BQ);

  // KV tiles that hold any unmasked key for this q-tile.
  const int q_first = q_offset + q0;
  const int q_last = q_first + q_rows - 1;
  const int n_tiles = (sk + BKV - 1) / BKV;
  const int kt_end = causal ? min(n_tiles, q_last / BKV + 1) : n_tiles;
  const int kt_begin = window > 0 ? max(0, q_first - window + 1) / BKV : 0;

  float m[4], l[4], acc[4][L::kOutCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kOutCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    const int k_rows = min(BKV, sk - k0);
    __syncthreads();  // the previous tile's readers of ks / vs / ps are done
    load_rows<T, D, L::kVec, L::kThreads>(ks, L::kLd, k_base + (size_t)k0 * kv_stride,
                                          kv_stride, k_rows, BKV);
    load_rows<T, D, L::kVec, L::kThreads>(vs, D, v_base + (size_t)k0 * kv_stride, kv_stride,
                                          k_rows, BKV);
    __syncthreads();

    float s[4][L::kScoreCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < L::kScoreCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[L::kScoreCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * L::kLd + d];
#pragma unroll
      for (int j = 0; j < L::kScoreCols; ++j) kv[j] = ks[(tx + 16 * j) * L::kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < L::kScoreCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < L::kScoreCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < sk && (!causal || qpos >= kpos) &&
                        (window <= 0 || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < L::kScoreCols; ++j) {
        // keys past the sequence end contribute nothing, even to a row whose
        // keys so far are all masked (where exp(s - m_new) is exp(0) = 1)
        const float p = k0 + tx + 16 * j < sk ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * L::kLdP + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kOutCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // ps complete

    for (int j = 0; j < k_rows; ++j) {
      float vv[L::kOutCols];
#pragma unroll
      for (int c = 0; c < L::kOutCols; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * L::kLdP + j];
#pragma unroll
        for (int c = 0; c < L::kOutCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t)b * sq + q0 + r) * q_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < L::kOutCols; ++c) out[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <typename T, int BQ, int BKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                   int sk, int n_heads, int n_kv, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  using L = Tile<T, BQ, BKV, D>;
  if constexpr (L::kSmem > kMaxSmem) {
    return cudaErrorInvalidValue;  // not compiled: the tiles do not fit a block's shared memory
  } else {
    auto kern = flash_attention_fwd_kernel<T, BQ, BKV, D>;
    if (L::kSmem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((sq + BQ - 1) / BQ, n_heads, batch);
    kern<<<grid, L::kThreads, L::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), sq, sk, n_heads, n_kv, causal, window, q_offset, scale);
    return cudaGetLastError();
  }
}

template <typename T, int BQ, int BKV>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int batch,
                       int sq, int sk, int n_heads, int n_kv, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, BQ, BKV, 16>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    case 32: return launch<T, BQ, BKV, 32>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    case 64: return launch<T, BQ, BKV, 64>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    case 128: return launch<T, BQ, BKV, 128>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BQ, int BKV>
long long smem_d(int d) {
  size_t bytes;
  switch (d) {
    case 16: bytes = Tile<float, BQ, BKV, 16>::kSmem; break;
    case 32: bytes = Tile<float, BQ, BKV, 32>::kSmem; break;
    case 64: bytes = Tile<float, BQ, BKV, 64>::kSmem; break;
    case 128: bytes = Tile<float, BQ, BKV, 128>::kSmem; break;
    default: return -1;
  }
  return bytes <= kMaxSmem ? (long long)bytes : -1;
}

}  // namespace

// Tensors are contiguous float32 (B,S,heads,D) and 16-byte aligned; the
// Python wrapper checks both before the call.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int batch, int sq, int sk, int n_heads, int n_kv, int d,
                                         int causal, int window, int q_offset, float scale,
                                         int block_q, int block_kv, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_kv == 64)
    return (int)dispatch_d<float, 64, 64>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  if (block_q == 64 && block_kv == 128)
    return (int)dispatch_d<float, 64, 128>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  if (block_q == 128 && block_kv == 64)
    return (int)dispatch_d<float, 128, 64>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  if (block_q == 128 && block_kv == 128)
    return (int)dispatch_d<float, 128, 128>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one instance in bytes, -1 where none is compiled.
extern "C" long long repro_flash_attention_smem_bytes(int block_q, int block_kv, int d) {
  if (block_q == 64 && block_kv == 64) return smem_d<64, 64>(d);
  if (block_q == 64 && block_kv == 128) return smem_d<64, 128>(d);
  if (block_q == 128 && block_kv == 64) return smem_d<128, 64>(d);
  if (block_q == 128 && block_kv == 128) return smem_d<128, 128>(d);
  return -1;
}
