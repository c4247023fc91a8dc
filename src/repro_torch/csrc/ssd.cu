// Mamba-2 SSD (state-space duality) chunked scan, forward, for Hopper (sm_90a),
// float32 with exact FMAs.
//
// Replaces: src/repro/kernels/ssd/kernel.py:ssd_pallas (the TPU kernel, body
// `_kernel`) for float32 x, B, C; bfloat16 goes to the tensor-core kernel of
// ssd_tc.cu (the Python wrapper picks the library by dtype, and this library
// takes float32 only: the float32 checks need exact f32 products, which
// TF32 or bf16 tensor cores would break).  It computes the function of the plain version
// src/repro_torch/kernels/ssd/ref.py:ssd_chunked (the reference's
// ref.ssd_chunked, the JAX model's default path), from a zero initial state:
//   x (B,S,H,P) in T, dt (B,S,H) f32 (already softplus'd), A (H,) f32,
//   B, C (B,S,G,N) in T (head h reads group h / (H/G)), D (H,) f32 or null;
//   y (B,S,H,P) in T and the final state (B,H,P,N) in f32 (null: not written).
// Per chunk of Q steps, with cs = inclusive cumsum(dt * A):
//   intra:  y_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//   inter:  y_i += exp(cs_i) (C_i . state)
//   state:  state = exp(cs_last) state + sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
// The skip term D*x is added in f32 before the one rounding of y to T, as
// ssd_chunked does (the Pallas kernel adds it after rounding y; the port
// matches ssd_chunked).  The decay exp(cs_i - cs_j) is evaluated only where
// i >= j, where the exponent is <= 0: above the diagonal it could overflow
// to inf, and inf times a 0/1 mask is NaN.
//
// What bounds it on this card: at mamba2-780m's largest serving prefill
// (bf16, B 1, S 1024, H 48, P 64, N 128, G 1) the function must move x and
// y (6.3 MB each), dt, B and C (0.7 MB) and the f32 state (1.6 MB): 14.9 MB,
// 4.4 us at 3.35 TB/s; its work in chunks of 64 (the causal half of C.B^T
// once per group, and per head the causal half of the intra-chunk product
// and the inter-chunk and state products) is 1.8 GFLOP, 1.8 us at 989
// TFLOP/s.  So bytes.  This first kernel is far
// from either: its products are f32 FMAs from shared memory, not tensor
// cores.
//
// Design.  The TPU kernel walks chunks on a sequential last grid axis and
// carries the (N, P) state in VMEM scratch.  Here one CUDA block owns one
// (b, h, slice of PS head-dim columns) and loops over the chunks itself; the
// (PS, N) state stays in shared memory for the whole sequence, so x is read
// once, y and the final state are written once, and the state never goes
// to device memory between chunks.  State columns are independent across
// P, so splitting P into slices multiplies the blocks (mamba2 at B 1: 96
// blocks instead of 48, on 132 SMs) at the price of recomputing C.B^T per
// slice.  Per chunk the block stages B and C (f32, Q x N), x and dt*x (Q x
// PS), computes the cumsum in one warp, then the Q x Q masked scores, y, and
// the state update, each as a register tile per thread over shared memory.
// Chunks need not divide S: rows past the end load as zeros (dt = 0 keeps
// the cumsum flat, B = x = 0 add nothing to the state) and are not stored.
// At Q 64, N 128, PS 32 the block takes 116 KB of dynamic shared memory,
// at Q 32 61 KB.  The result does not depend on the chunk beyond f32
// summation order.  Compiled: chunk 32 and 64, N 16 (hymba-1.5b) and 128
// (mamba2-780m), PS 32, 16 and 8 (head dims that are multiples of 32, of 16
// only, and 8: hymba-1.5b's head-dim shard on a model axis of 16), f32.
//
// Thread layout: 256 threads; kYc = min(PS, 16) and kSr = min(PS, 16).
//   scores: 16 row groups (ty) x 16 lanes (tx): rows ty*Q/16 .. +Q/16-1,
//           columns tx + 16c (Q/16 x Q/16 each)
//   y:      256/kYc row groups (yr) x kYc lanes (yc): rows yr*kRy .. +kRy-1,
//           columns yc + kYc c (kRy = Q kYc/256 rows x PS/kYc columns each)
//   state:  kSr row groups (sr) x min(N, 256/kSr) lanes (sc): rows
//           sr*PS/kSr .., columns sc + lanes c; at PS 8 and N 16 only 128
//           threads hold a state element
// At PS 16 and 32 the y and state layouts are the scores' (16 x 16).
// Shared rows of B, C, the state and the scores have odd strides (N+1, Q+1)
// so the 16 lanes that read 16 different rows hit 16 different banks.
//
// Entry point: repro_ssd_fwd (plain C, called through ctypes); it launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int Q, int N, int PS>
struct Layout {
  static constexpr int kRq = Q / 16;   // score rows and columns per thread
  static constexpr int kYc = PS < 16 ? PS : 16;            // y: lanes on the columns
  static constexpr int kRy = Q * kYc / kThreads;           // ... y rows per thread
  static constexpr int kPc = PS / kYc;                     // ... y columns per thread
  static constexpr int kSr = PS < 16 ? PS : 16;            // state: row groups
  static constexpr int kSx = N < kThreads / kSr ? N : kThreads / kSr;   // ... lanes
  static constexpr int kSp = PS / kSr;                     // ... state rows per thread
  static constexpr int kNc = N / kSx;                      // ... state columns per thread
  static constexpr int kLdN = N + 1;   // row stride of B, C and the state
  static constexpr int kLdQ = Q + 1;   // row stride of the scores
  // B, C (Q x kLdN), scores (Q x kLdQ), x and dt*x (Q x PS), state (PS x
  // kLdN), dt, cs and the state-update weights (Q each)
  static constexpr size_t kFloats =
      2 * (size_t)Q * kLdN + (size_t)Q * kLdQ + 2 * (size_t)Q * PS + (size_t)PS * kLdN + 3 * Q;
  static constexpr size_t kSmem = kFloats * sizeof(float);
  static_assert(Q == 32 || Q == 64, "chunk");
  static_assert(N % 16 == 0 && (PS % 16 == 0 || PS == 8), "N a multiple of 16, PS of 16 or 8");
};

template <typename T, int Q, int N, int PS>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ D, T* __restrict__ y, float* __restrict__ state_out,
               int seq, int n_heads, int head_dim, int n_groups) {
  using L = Layout<Q, N, PS>;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                    // B chunk   [Q][kLdN]
  float* cs_mat = bs + Q * L::kLdN;    // C chunk   [Q][kLdN]
  float* ss = cs_mat + Q * L::kLdN;    // scores    [Q][kLdQ]
  float* xs = ss + Q * L::kLdQ;        // x         [Q][PS]
  float* dtx = xs + Q * PS;            // dt * x    [Q][PS]
  float* st = dtx + Q * PS;            // state     [PS][kLdN]
  float* dts = st + PS * L::kLdN;      // dt        [Q]
  float* cum = dts + Q;                // cumsum    [Q]
  float* wts = cum + Q;                // exp(cs_last - cs_j) [Q]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int yc = tid % L::kYc, yr = tid / L::kYc;    // y's layout
  const int sc = tid % L::kSx, sr = tid / L::kSx;    // the state's (sr >= kSr: idle)
  const bool holds_state = sr < L::kSr;
  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (n_heads / n_groups);
  const float a = A[h];
  const float d_skip = D != nullptr ? D[h] : 0.f;
  const size_t x_row = (size_t)n_heads * head_dim;   // element stride between steps
  const size_t bc_row = (size_t)n_groups * N;

  for (int e = tid; e < PS * L::kLdN; e += kThreads) st[e] = 0.f;

  const int n_chunks = (seq + Q - 1) / Q;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int s0 = chunk * Q;
    const int rows = min(Q, seq - s0);
    const size_t step0 = (size_t)b * seq + s0;
    __syncthreads();  // the previous chunk's readers are done (and st is zeroed)

    // ---- stage the chunk; rows past the sequence end are zeros
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = i < rows ? dt[(step0 + i) * n_heads + h] : 0.f;
    const T* xg = x + step0 * x_row + (size_t)h * head_dim + p0;
    for (int e = tid; e < Q * PS; e += kThreads) {
      const int i = e / PS, p = e % PS;
      xs[e] = i < rows ? to_f32(xg[(size_t)i * x_row + p]) : 0.f;
    }
    const T* bg = Bm + step0 * bc_row + (size_t)g * N;
    const T* cg = Cm + step0 * bc_row + (size_t)g * N;
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const bool ok = i < rows;
      bs[i * L::kLdN + n] = ok ? to_f32(bg[(size_t)i * bc_row + n]) : 0.f;
      cs_mat[i * L::kLdN + n] = ok ? to_f32(cg[(size_t)i * bc_row + n]) : 0.f;
    }
    __syncthreads();

    // ---- cumsum of dt*A in warp 0 (Q/32 consecutive steps per lane), dt*x elsewhere
    if (tid < 32) {
      constexpr int kE = Q / 32;
      float loc[kE];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        run += dts[tid * kE + k] * a;
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < kE; ++k) cum[tid * kE + k] = excl + loc[k];
    }
    for (int e = tid; e < Q * PS; e += kThreads) dtx[e] = dts[e / PS] * xs[e];
    __syncthreads();

    // ---- scores S[i][j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i, else 0
    const float total = cum[Q - 1];
    if (tid < Q) wts[tid] = expf(total - cum[tid]);
    {
      float acc[L::kRq][L::kRq];
#pragma unroll
      for (int r = 0; r < L::kRq; ++r)
#pragma unroll
        for (int c = 0; c < L::kRq; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[L::kRq], bv[L::kRq];
#pragma unroll
        for (int r = 0; r < L::kRq; ++r) cv[r] = cs_mat[(ty * L::kRq + r) * L::kLdN + n];
#pragma unroll
        for (int c = 0; c < L::kRq; ++c) bv[c] = bs[(tx + 16 * c) * L::kLdN + n];
#pragma unroll
        for (int r = 0; r < L::kRq; ++r)
#pragma unroll
          for (int c = 0; c < L::kRq; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < L::kRq; ++r) {
        const int i = ty * L::kRq + r;
#pragma unroll
        for (int c = 0; c < L::kRq; ++c) {
          const int j = tx + 16 * c;
          ss[i * L::kLdQ + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = scores . (dt x) + exp(cs) (C . state) + D x, stored in T
    {
      float yi[L::kRy][L::kPc], ye[L::kRy][L::kPc];
#pragma unroll
      for (int r = 0; r < L::kRy; ++r)
#pragma unroll
        for (int c = 0; c < L::kPc; ++c) yi[r][c] = ye[r][c] = 0.f;
      const int j_end = yr * L::kRy + L::kRy;  // scores are 0 past this thread's last row
      for (int j = 0; j < j_end; ++j) {
        float sv[L::kRy], xv[L::kPc];
#pragma unroll
        for (int r = 0; r < L::kRy; ++r) sv[r] = ss[(yr * L::kRy + r) * L::kLdQ + j];
#pragma unroll
        for (int c = 0; c < L::kPc; ++c) xv[c] = dtx[j * PS + yc + L::kYc * c];
#pragma unroll
        for (int r = 0; r < L::kRy; ++r)
#pragma unroll
          for (int c = 0; c < L::kPc; ++c) yi[r][c] = fmaf(sv[r], xv[c], yi[r][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[L::kRy], sv[L::kPc];
#pragma unroll
        for (int r = 0; r < L::kRy; ++r) cv[r] = cs_mat[(yr * L::kRy + r) * L::kLdN + n];
#pragma unroll
        for (int c = 0; c < L::kPc; ++c) sv[c] = st[(yc + L::kYc * c) * L::kLdN + n];
#pragma unroll
        for (int r = 0; r < L::kRy; ++r)
#pragma unroll
          for (int c = 0; c < L::kPc; ++c) ye[r][c] = fmaf(cv[r], sv[c], ye[r][c]);
      }
      T* yg = y + step0 * x_row + (size_t)h * head_dim + p0;
#pragma unroll
      for (int r = 0; r < L::kRy; ++r) {
        const int i = yr * L::kRy + r;
        if (i >= rows) continue;
        const float decay_in = expf(cum[i]);
#pragma unroll
        for (int c = 0; c < L::kPc; ++c) {
          const int p = yc + L::kYc * c;
          const float out = yi[r][c] + decay_in * ye[r][c] + d_skip * xs[i * PS + p];
          store(yg + (size_t)i * x_row + p, out);
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // ---- state = exp(cs_last) state + sum_j exp(cs_last - cs_j) (dt_j x_j) (x) B_j
    if (holds_state) {
      const float decay = expf(total);
      float acc[L::kSp][L::kNc];
#pragma unroll
      for (int r = 0; r < L::kSp; ++r)
#pragma unroll
        for (int c = 0; c < L::kNc; ++c)
          acc[r][c] = st[(sr * L::kSp + r) * L::kLdN + sc + L::kSx * c] * decay;
      for (int j = 0; j < rows; ++j) {
        const float w = wts[j];
        float xv[L::kSp], bv[L::kNc];
#pragma unroll
        for (int r = 0; r < L::kSp; ++r) xv[r] = dtx[j * PS + sr * L::kSp + r] * w;
#pragma unroll
        for (int c = 0; c < L::kNc; ++c) bv[c] = bs[j * L::kLdN + sc + L::kSx * c];
#pragma unroll
        for (int r = 0; r < L::kSp; ++r)
#pragma unroll
          for (int c = 0; c < L::kNc; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < L::kSp; ++r)
#pragma unroll
        for (int c = 0; c < L::kNc; ++c)
          st[(sr * L::kSp + r) * L::kLdN + sc + L::kSx * c] = acc[r][c];
    }
  }

  if (state_out == nullptr) return;
  __syncthreads();
  float* sg = state_out + ((size_t)b * n_heads + h) * head_dim * N + (size_t)p0 * N;
  for (int e = tid; e < PS * N; e += kThreads) sg[e] = st[(e / N) * L::kLdN + e % N];
}

template <typename T, int Q, int N, int PS>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* D, void* y, float* state, int batch, int seq,
                   int n_heads, int head_dim, int n_groups, cudaStream_t stream) {
  using L = Layout<Q, N, PS>;
  auto kern = ssd_fwd_kernel<T, Q, N, PS>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(head_dim / PS, n_heads, batch);
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      static_cast<T*>(y), state, seq, n_heads, head_dim, n_groups);
  return cudaGetLastError();
}

template <typename T, int Q, int PS>
cudaError_t dispatch_n(int n, const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, void* y, float* state, int batch,
                       int seq, int n_heads, int head_dim, int n_groups, cudaStream_t s) {
  switch (n) {
    case 16: return launch<T, Q, 16, PS>(x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
    case 128: return launch<T, Q, 128, PS>(x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int chunk, int p_slice, int n, const void* x, const float* dt,
                     const float* A, const void* Bm, const void* Cm, const float* D, void* y,
                     float* state, int batch, int seq, int n_heads, int head_dim, int n_groups,
                     cudaStream_t s) {
  if (chunk == 64 && p_slice == 32)
    return dispatch_n<T, 64, 32>(n, x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
  if (chunk == 64 && p_slice == 16)
    return dispatch_n<T, 64, 16>(n, x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
  if (chunk == 32 && p_slice == 32)
    return dispatch_n<T, 32, 32>(n, x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
  if (chunk == 32 && p_slice == 16)
    return dispatch_n<T, 32, 16>(n, x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
  if (chunk == 64 && p_slice == 8)
    return dispatch_n<T, 64, 8>(n, x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
  if (chunk == 32 && p_slice == 8)
    return dispatch_n<T, 32, 8>(n, x, dt, A, Bm, Cm, D, y, state, batch, seq, n_heads, head_dim, n_groups, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype must be 0 (float32 x, B, C and y): bfloat16 is ssd_tc.cu's.  dt, A,
// D and the state are float32; D and state may be null.  Tensors are contiguous; the Python
// wrapper checks shapes, dtypes and contiguity before the call.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* D, void* y, void* state, int dtype,
                             int batch, int seq, int n_heads, int head_dim, int n_groups,
                             int state_dim, int chunk, int p_slice, void* stream) {
  if (batch <= 0 || seq <= 0 || n_heads <= 0 || n_groups <= 0 || n_heads % n_groups != 0 ||
      p_slice <= 0 || head_dim % p_slice != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return (int)dispatch<float>(chunk, p_slice, state_dim, x, dtf, af, Bm, Cm, df, y, sf, batch, seq, n_heads, head_dim, n_groups, s);
  return (int)cudaErrorInvalidValue;
}
