// Mamba-2 SSD (state-space duality) chunked scan, forward, bfloat16, on
// Hopper's tensor cores (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py:ssd_pallas (the TPU kernel, body
// `_kernel`) for bfloat16 x, B, C; float32 goes to the exact FMA kernel of
// ssd.cu (the Python wrapper picks the library by dtype, and this library
// takes bfloat16 only).  Same function as the plain version
// src/repro_torch/kernels/ssd/ref.py:ssd_chunked, from a zero initial state:
//   x (B,S,H,P) bf16, dt (B,S,H) f32 (already softplus'd), A (H,) f32,
//   B, C (B,S,G,N) bf16 (head h reads group h / (H/G)), D (H,) f32 or null;
//   y (B,S,H,P) bf16 and the final state (B,H,P,N) f32 (null: not written).
// With cs = the inclusive cumsum of dt*A inside a chunk of Q steps:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//       + exp(cs_i) C_i . state_in + D x_i        (one rounding, after D x)
//   state_out = exp(cs_last) state_in + sum_j x_j (x) exp(cs_last - cs_j) dt_j B_j
// The decay exp(cs_i - cs_j) is taken only where i >= j (the exponent is
// <= 0 there; above the diagonal it could overflow).
//
// What bounds it on this card: at mamba2-780m's widest serving prefill
// (B 1, S 1024, H 48, P 64, N 128, G 1) the function must move x and y (6.3
// MB each), dt, B and C (0.7 MB) and the f32 final state (1.6 MB): 14.9 MB,
// 4.4 us at 3.35 TB/s; its products in chunks of 64 are 1.8 GFLOP, 1.8 us
// at 989 TFLOP/s.  So bytes.  The chunked algorithm adds its own: the
// chunk states go through device memory (mostly the 50 MB L2) between the
// passes below.
//
// Design: the Mamba-2 paper's GPU decomposition (arXiv:2405.21060 s. 6), as
// three launches on the caller's stream.  Every chunk runs in parallel in
// passes 1 and 3; only pass 2 walks the chunks, elementwise.
//   1. Chunk states, grid (chunk, group x head block, b).  A block stages
//      the chunk's B (shared by its heads) and each head's x with cp.async,
//      takes each head's cumsum in one warp, and computes the chunk's local
//      state S_c[p][n] = sum_j (x_j[p] w_j) B_j[n], w_j = exp(cs_last -
//      cs_j) dt_j, as mma.sync m16n8k16 tiles (bf16 in, f32 sum), P on the
//      m16 side: a head dim of 8 is staged as 16 rows whose last 8 are
//      zeros (cp.async's zero fill), and only its 8 rows are stored.  The
//      scaled operand x w is f32: it is split into a bf16 high part and a
//      bf16 low part (the rest) and both are multiplied, so the state is
//      good to ~2^-16 of each term; one rounding of it to bf16 would put
//      the final state outside its 1e-3 tolerance.  Writes S_c and
//      exp(cs_last) in f32 to scratch.
//         reads x, B (6.6 MB), writes S_c: B (S/Q) H P N f32 (25.2 MB).
//   2. State passing, grid (P N / 512, H, b): each thread walks the chunks
//      for 4 state elements, in f32: in_c = state; state = exp(cs_last_c)
//      state + S_c.  It writes the state entering each chunk rounded to
//      bf16 (it feeds only y's C . state product) and the final state.
//         reads 25.2 MB, writes 12.6 MB (+ the 1.6 MB final state).
//   3. Chunk scan, grid (chunk, group x head block, b), launched with
//      programmatic stream serialization: C, B and the first heads' x are
//      staged, the cumsums taken and C . B^T computed while pass 2 is still
//      running; griddepcontrol.wait holds back only the load of in_c.  Each
//      warp owns 16 rows of the chunk and computes their C . B^T once for
//      all the block's heads, keeping it and its C fragments in registers.
//      Per head (x and in_c staged with cp.async, two heads in flight): M =
//      C.B^T * exp(cs_i - cs_j) * dt_j, rounded once to bf16 straight into
//      the A-fragment layout (as attention's P), then y = exp(cs_i) (C .
//      in_c^T) + M . x + D x, rounded once and stored.  The products run
//      over whole tiles (M is 0 above the diagonal, where the exponent is
//      -inf) and the head dim is a template parameter (P is the n side of
//      both products: blocks of 16 columns, two n8 tiles, or at P 8 one
//      block of one n8 tile): loops with
//      compile-time bounds and no per-warp branches, which the compiler
//      software-pipelines (ldmatrix ahead of mma).
//         reads x, B, C, in_c (19.5 MB), writes y (6.3 MB).
// Where bf16 rounds: the inputs (given), the split operand of pass 1 (hi +
// lo, see above), M and in_c in pass 3 (each error stays inside y's bf16
// tolerance).  Every sum is f32.
//
// Blocks of passes 1 and 3 take up to 4 heads of one group: the largest
// head block that still gives every SM a block (more heads share B and
// C . B^T; fewer keep short sequences spread over the card).  A ragged last
// head block is masked.  Rows past the sequence end load as zeros (dt = 0
// keeps the cumsum flat, x = B = C = 0 add nothing) and are not stored.
// Each warp's mma fragments are read with ldmatrix from shared rows padded
// by 16 bytes, so the 8 rows of an 8x8 matrix hit 8 distinct bank groups.
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A registers
// hold (row g, cols 2t, 2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); B
// (k 2t, 2t+1 | col g), (k 2t+8.. | g); the f32 accumulator (g, 2t..),
// (g+8, 2t..).
//
// Compiled: chunk Q 32 and 64, state N 16 (hymba-1.5b) and 128 (mamba2-780m),
// head dim P 8, 16, 32, 64 and 128 (pass 3; pass 1 loops over P at run time).
// P 8 is hymba-1.5b's head-dim shard on a model axis of 16 (its 25 SSM heads
// do not divide 16, so the sharding rules split its head dim of 128): at
// (B 2, S 32768, H 25, P 8, N 16) the function moves x and y (26.2 MB
// each), dt (6.6 MB), B and C (2.1 MB each) and the final state: 63.2 MB,
// 18.9 us at 3.35 TB/s; the passes add their scratch: 13.1 MB of f32 chunk
// states (written by pass 1, read by pass 2) and 6.6 MB of bf16 entering
// states (written by pass 2, read by pass 3).
//
// Entry point: repro_ssd_tc_fwd (plain C, called through ctypes); it
// launches the three passes on the caller's stream and returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadBlock = 4;  // heads a block of pass 1 or 3 takes, at most
constexpr int kPad = 8;           // bf16 padding of a shared row (16 bytes)
constexpr int kPassThreads = 128; // pass 2: 4 state elements a thread
constexpr float kNegInf = -__builtin_huge_valf();

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Programmatic dependent launch: the next kernel may start now / this one
// waits until the previous kernel's writes are visible.
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// two 8x8 matrices into r[0], r[1] (lanes 0-15 give the rows)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// v (two bf16) times (w0, w1) in f32, as a bf16 high part and a bf16 low part.
__device__ __forceinline__ void split_scaled(uint32_t v, float w0, float w1, uint32_t& hi,
                                             uint32_t& lo) {
  const float2 f = unpack(v);
  const float a = f.x * w0, b = f.y * w1;
  hi = pack(a, b);
  const float2 h = unpack(hi);
  lo = pack(a - h.x, b - h.y);
}

// One warp: dt of a head's chunk (rows past the end are 0) into dts, the
// inclusive cumsum of dt*a into cs; returns cs[Q-1] to every lane.
template <int Q>
__device__ __forceinline__ float chunk_cumsum(const float* __restrict__ dt, int stride, int rows,
                                              float a, float* dts, float* cs, int lane) {
  constexpr int kE = Q / 32;
  float d[kE], loc[kE];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int i = lane * kE + k;
    d[k] = i < rows ? dt[(size_t)i * stride] : 0.f;
    run += d[k] * a;
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    dts[lane * kE + k] = d[k];
    cs[lane * kE + k] = excl + loc[k];
  }
  return __shfl_sync(0xffffffffu, incl, 31);
}

struct Shape {
  int seq, n_heads, head_dim, n_groups, n_chunks;
  int head_block;  // heads a block of pass 1 or 3 takes: 1, 2 or kMaxHeadBlock
};

// The block's group, first head and number of heads (head_block heads of
// one group; the last block of a group may take fewer).
struct HeadBlock {
  int g, h0, n;
  __device__ HeadBlock(const Shape& s) {
    const int per_group = s.n_heads / s.n_groups;
    const int blocks = (per_group + s.head_block - 1) / s.head_block;
    g = blockIdx.y / blocks;
    h0 = g * per_group + (blockIdx.y % blocks) * s.head_block;
    n = min(s.head_block, (g + 1) * per_group - h0);
  }
};

// Head-dim rows of pass 1: P rounded up to the m16 tile.
__host__ __device__ constexpr int rows16(int p) { return (p + 15) / 16 * 16; }
// Row stride of x in pass 3: padded by 16 bytes, but at P 8 a row is 16
// bytes and 8 unpadded rows already hit 8 distinct bank groups.
__host__ __device__ constexpr int ld_x(int p) { return p == 8 ? p : p + kPad; }

template <int Q, int N>
struct Smem {
  static constexpr int kLdN = N + kPad;
  static size_t states(int p, int heads) {  // pass 1: B, each head's x, weights and cs
    return 2 * ((size_t)Q * kLdN + (size_t)heads * Q * (rows16(p) + kPad)) +
           2 * 4 * kMaxHeadBlock * Q;
  }
  static size_t scan(int p) {    // pass 3: C, B, two heads' x and in_c, dt and cs of each head
    return 2 * (2 * (size_t)Q * kLdN + 2 * (size_t)Q * ld_x(p) + 2 * (size_t)p * kLdN) +
           2 * 4 * kMaxHeadBlock * Q;
  }
  static_assert(Q == 32 || Q == 64, "chunk");
  static_assert(N % 16 == 0, "state dim");
};

// ------------------------------------------------------------------ pass 1
template <int Q, int N>
__global__ void __launch_bounds__(kThreads)
ssd_tc_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     float* __restrict__ states, float* __restrict__ decay, Shape s) {
  constexpr int kLdN = Smem<Q, N>::kLdN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = s.head_dim, P16 = rows16(P), ldp = P16 + kPad;
  bf16* bs = reinterpret_cast<bf16*>(smem);       // B      [Q][kLdN]
  bf16* xs = bs + Q * kLdN;                        // x      [head_block][Q][ldp]
  float* wts = reinterpret_cast<float*>(xs + s.head_block * Q * ldp);  // weights [4][Q]
  float* css = wts + kMaxHeadBlock * Q;                                 // cumsums [4][Q]

  const HeadBlock hb(s);
  const int chunk = blockIdx.x, b = blockIdx.z;
  const int s0 = chunk * Q, rows = min(Q, s.seq - s0);
  const size_t step0 = (size_t)b * s.seq + s0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* bg = Bm + step0 * s.n_groups * N + (size_t)hb.g * N;
  for (int e = tid; e < Q * (N / 8); e += kThreads) {
    const int i = e / (N / 8), c = e % (N / 8);
    cp_async16(bs + i * kLdN + c * 8, bg + (size_t)(i < rows ? i : 0) * s.n_groups * N + c * 8,
               i < rows);
  }
  // columns P..P16-1 (only at P 8) load as zeros: they add nothing to the tile
  const int pc = P / 8, pc16 = P16 / 8;
  for (int e = tid; e < hb.n * Q * pc16; e += kThreads) {
    const int hl = e / (Q * pc16), i = e / pc16 % Q, c = e % pc16;
    cp_async16(xs + (hl * Q + i) * ldp + c * 8,
               x + (step0 + (i < rows ? i : 0)) * s.n_heads * P + (size_t)(hb.h0 + hl) * P +
                   (c < pc ? c : 0) * 8,
               i < rows && c < pc);
  }
  cp_async_commit();

  // per head, in one warp: the cumsum, the weights exp(cs_last - cs_j) dt_j
  // (in place of dt; each lane rewrites its own steps) and the chunk's decay
  for (int hl = warp; hl < hb.n; hl += kWarps) {
    const int h = hb.h0 + hl;
    float* w = wts + hl * Q;
    float* cs = css + hl * Q;
    const float total = chunk_cumsum<Q>(dt + step0 * s.n_heads + h, s.n_heads, rows, A[h], w, cs,
                                        lane);
#pragma unroll
    for (int k = 0; k < Q / 32; ++k) {
      const int j = lane * (Q / 32) + k;
      w[j] = expf(total - cs[j]) * w[j];
    }
    if (lane == 0) decay[((size_t)b * s.n_chunks + chunk) * s.n_heads + h] = expf(total);
  }
  cp_async_wait<0>();
  __syncthreads();

  // units of (head, 16 rows of P) over the warps; each a 16 x N f32 tile
  const int gq = lane >> 2, tq = lane & 3;   // fragment row group and column pair
  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: this lane's matrix and its row
  const int m_tiles = P16 / 16;
  for (int u = warp; u < hb.n * m_tiles; u += kWarps) {
    const int hl = u / m_tiles, m0 = (u % m_tiles) * 16;
    const bf16* xh = xs + hl * Q * ldp;
    const float* w = wts + hl * Q;
    float acc[N / 8][4];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < Q / 16; ++kb) {
      const int k0 = kb * 16;
      // A[p][j] = x[j][p] w_j: x^T through ldmatrix.trans, then scaled and split
      uint32_t a[4], hi[4], lo[4];
      ldsm_x4_t(a, xh + (k0 + (mi >> 1) * 8 + r8) * ldp + m0 + (mi & 1) * 8);
      const float w0 = w[k0 + 2 * tq], w1 = w[k0 + 2 * tq + 1];
      const float w8 = w[k0 + 8 + 2 * tq], w9 = w[k0 + 9 + 2 * tq];
      split_scaled(a[0], w0, w1, hi[0], lo[0]);
      split_scaled(a[1], w0, w1, hi[1], lo[1]);
      split_scaled(a[2], w8, w9, hi[2], lo[2]);
      split_scaled(a[3], w8, w9, hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];  // B[j][n] for n-tiles 2np, 2np+1
        ldsm_x4_t(bf, bs + (k0 + (mi & 1) * 8 + r8) * kLdN + np * 16 + (mi >> 1) * 8);
        mma(acc[2 * np], hi, bf[0], bf[1]);
        mma(acc[2 * np], lo, bf[0], bf[1]);
        mma(acc[2 * np + 1], hi, bf[2], bf[3]);
        mma(acc[2 * np + 1], lo, bf[2], bf[3]);
      }
    }
    float* sg = states + ((((size_t)b * s.n_chunks + chunk) * s.n_heads + hb.h0 + hl) * P + m0) * N;
    const bool upper = m0 + gq + 8 < P;    // rows 8-15 of the tile: none at P 8
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      *reinterpret_cast<float2*>(sg + gq * N + nt * 8 + 2 * tq) = make_float2(acc[nt][0], acc[nt][1]);
      if (upper)
        *reinterpret_cast<float2*>(sg + (gq + 8) * N + nt * 8 + 2 * tq) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ------------------------------------------------------------------ pass 2
__global__ void __launch_bounds__(kPassThreads)
ssd_tc_pass_kernel(const float* __restrict__ states, const float* __restrict__ decay,
                   bf16* __restrict__ ins, float* __restrict__ state_out, int n_chunks,
                   int n_heads, int pn) {
  grid_dependents_launch();  // the scan's prologue needs nothing of this pass
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < n_chunks; ++c) {
    const size_t bch = ((size_t)b * n_chunks + c) * n_heads + h;
    const float4 sc = *reinterpret_cast<const float4*>(states + bch * pn + e);
    const float d = decay[bch];
    *reinterpret_cast<uint2*>(ins + bch * pn + e) = make_uint2(pack(st.x, st.y), pack(st.z, st.w));
    st = make_float4(d * st.x + sc.x, d * st.y + sc.y, d * st.z + sc.z, d * st.w + sc.w);
  }
  if (state_out != nullptr)
    *reinterpret_cast<float4*>(state_out + ((size_t)b * n_heads + h) * pn + e) = st;
}

// ------------------------------------------------------------------ pass 3
template <int Q, int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_tc_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const float* __restrict__ D,
                   const bf16* __restrict__ ins, bf16* __restrict__ y, Shape s) {
  static_assert(P == 8 || P % 16 == 0, "head dim");
  constexpr int kLdN = Smem<Q, N>::kLdN;
  constexpr int kLdP = ld_x(P);
  constexpr int kIT = Q / 16;                 // 16-row tiles of the chunk
  constexpr int kWpt = kWarps / kIT;          // warps a row tile (1 at Q 64, 2 at Q 32)
  constexpr int kCW = P < 16 ? P : 16;        // columns of P a column block: 16, or 8 at P 8
  constexpr int kNB = kCW / 8;                // its n8 tiles
  constexpr int kCB = P / kCW;                // column blocks of P
  constexpr int kPB = (kCB + kWpt - 1) / kWpt;   // column blocks a warp takes
  constexpr int kGroup = kPB < 4 ? kPB : 4;   // ... this many at once
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs_m = reinterpret_cast<bf16*>(smem);     // C       [Q][kLdN]
  bf16* bs = cs_m + Q * kLdN;                      // B       [Q][kLdN]
  bf16* xs = bs + Q * kLdN;                        // x       [2][Q][kLdP]
  bf16* st = xs + 2 * Q * kLdP;                    // in_c    [2][P][kLdN]
  float* dts = reinterpret_cast<float*>(st + 2 * P * kLdN);  // [kMaxHeadBlock][Q]
  float* css = dts + kMaxHeadBlock * Q;                       // [kMaxHeadBlock][Q]

  const HeadBlock hb(s);
  const int chunk = blockIdx.x, b = blockIdx.z;
  const int s0 = chunk * Q, rows = min(Q, s.seq - s0);
  const size_t step0 = (size_t)b * s.seq + s0;
  const size_t x_row = (size_t)s.n_heads * P, bc_row = (size_t)s.n_groups * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto stage_x = [&](int hl) {
    bf16* xd = xs + (hl & 1) * Q * kLdP;
    const bf16* xg = x + step0 * x_row + (size_t)(hb.h0 + hl) * P;
    for (int e = tid; e < Q * (P / 8); e += kThreads) {
      const int i = e / (P / 8), c = e % (P / 8);
      cp_async16(xd + i * kLdP + c * 8, xg + (size_t)(i < rows ? i : 0) * x_row + c * 8, i < rows);
    }
  };
  auto stage_state = [&](int hl) {
    bf16* sd = st + (hl & 1) * P * kLdN;
    const bf16* sg = ins + (((size_t)b * s.n_chunks + chunk) * s.n_heads + hb.h0 + hl) * P * N;
    for (int e = tid; e < P * (N / 8); e += kThreads) {
      const int p = e / (N / 8), c = e % (N / 8);
      cp_async16(sd + p * kLdN + c * 8, sg + (size_t)p * N + c * 8, true);
    }
  };

  // What does not depend on pass 2 runs while it finishes: C, B and the
  // first two heads' x, the cumsums, and C . B^T.
  const bf16* bg = Bm + step0 * bc_row + (size_t)hb.g * N;
  const bf16* cg = Cm + step0 * bc_row + (size_t)hb.g * N;
  for (int e = tid; e < Q * (N / 8); e += kThreads) {
    const int i = e / (N / 8), c = e % (N / 8);
    const size_t off = (size_t)(i < rows ? i : 0) * bc_row + c * 8;
    cp_async16(cs_m + i * kLdN + c * 8, cg + off, i < rows);
    cp_async16(bs + i * kLdN + c * 8, bg + off, i < rows);
  }
  stage_x(0);
  if (hb.n > 1) stage_x(1);
  cp_async_commit();
  for (int hl = warp; hl < hb.n; hl += kWarps)
    chunk_cumsum<Q>(dt + step0 * s.n_heads + hb.h0 + hl, s.n_heads, rows, A[hb.h0 + hl],
                    dts + hl * Q, css + hl * Q, lane);
  cp_async_wait<0>();
  __syncthreads();

  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
  const int it = warp % kIT, i0 = it * 16;
  const int ra = i0 + gq, rb = ra + 8;      // this thread's two rows of the chunk
  const int pb0 = warp / kIT;               // its column blocks: pb0 + kWpt k
  const bool active = pb0 < kCB;            // false only where kCB < kWpt

  // C fragments of rows i0..i0+15 (A of the C . in_c^T product), for every head
  uint32_t cf[N / 16][4];
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
    ldsm_x4(cf[ks], cs_m + (i0 + (mi & 1) * 8 + r8) * kLdN + ks * 16 + (mi >> 1) * 8);
  // C . B^T of these rows over every column (M masks the upper triangle);
  // shared by every head of the block
  float cb[Q / 8][4];
#pragma unroll
  for (int nt = 0; nt < Q / 8; ++nt) cb[nt][0] = cb[nt][1] = cb[nt][2] = cb[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t bf[kIT][4];  // B^T[n][j] for j-tiles 2np, 2np+1
#pragma unroll
    for (int np = 0; np < kIT; ++np)
      ldsm_x4(bf[np], bs + (np * 16 + (mi >> 1) * 8 + r8) * kLdN + ks * 16 + (mi & 1) * 8);
#pragma unroll
    for (int np = 0; np < kIT; ++np) {
      mma(cb[2 * np], cf[ks], bf[np][0], bf[np][1]);
      mma(cb[2 * np + 1], cf[ks], bf[np][2], bf[np][3]);
    }
  }

  grid_dependency_wait();  // pass 2 has written every in_c
  stage_state(0);
  cp_async_commit();
  if (hb.n > 1) stage_state(1);
  cp_async_commit();

  for (int hl = 0; hl < hb.n; ++hl) {
    const int h = hb.h0 + hl;
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xh = xs + (hl & 1) * Q * kLdP;
    const bf16* sh = st + (hl & 1) * P * kLdN;
    const float* csh = css + hl * Q;
    const float* dth = dts + hl * Q;
    const float cs_a = csh[ra], cs_b = csh[rb];

    // M = C.B^T exp(cs_i - cs_j) dt_j, rounded to bf16 in the A layout; the
    // exponent is -inf above the diagonal, so exp never sees a positive one
    uint32_t mf[kIT][4];
#pragma unroll
    for (int nt = 0; nt < Q / 8; ++nt) {
      const int j = nt * 8 + 2 * tq;
      const float c0 = csh[j], c1 = csh[j + 1], d0 = dth[j], d1 = dth[j + 1];
      const float m00 = cb[nt][0] * __expf(j <= ra ? cs_a - c0 : kNegInf) * d0;
      const float m01 = cb[nt][1] * __expf(j + 1 <= ra ? cs_a - c1 : kNegInf) * d1;
      const float m10 = cb[nt][2] * __expf(j <= rb ? cs_b - c0 : kNegInf) * d0;
      const float m11 = cb[nt][3] * __expf(j + 1 <= rb ? cs_b - c1 : kNegInf) * d1;
      mf[nt / 2][2 * (nt % 2)] = pack(m00, m01);
      mf[nt / 2][2 * (nt % 2) + 1] = pack(m10, m11);
    }
    const float dec_a = __expf(cs_a), dec_b = __expf(cs_b);
    const float dh = D != nullptr ? D[h] : 0.f;
    bf16* yg = y + step0 * x_row + (size_t)h * P;

    if (active) {
#pragma unroll
      for (int g0 = 0; g0 < kPB; g0 += kGroup) {
        float acc[kGroup][kNB][4];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int n = 0; n < kNB; ++n) acc[g][n][0] = acc[g][n][1] = acc[g][n][2] = acc[g][n][3] = 0.f;
        // exp(cs_i) C . in_c^T
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t bf[kGroup][4];  // in_c[p][n] for p-tiles p0 (and p0+8)
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const bf16* sp = sh + (pb0 + (g0 + g) * kWpt) * kCW * kLdN + ks * 16 + (mi & 1) * 8;
            if constexpr (kNB == 2)
              ldsm_x4(bf[g], sp + ((mi >> 1) * 8 + r8) * kLdN);
            else
              ldsm_x2(bf[g], sp + r8 * kLdN);
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
#pragma unroll
            for (int n = 0; n < kNB; ++n) mma(acc[g][n], cf[ks], bf[g][2 * n], bf[g][2 * n + 1]);
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            acc[g][n][0] *= dec_a;
            acc[g][n][1] *= dec_a;
            acc[g][n][2] *= dec_b;
            acc[g][n][3] *= dec_b;
          }
        // + M . x
#pragma unroll
        for (int kb = 0; kb < kIT; ++kb) {
          uint32_t bf[kGroup][4];  // x[j][p] for p-tiles p0 (and p0+8)
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const bf16* xp = xh + (kb * 16 + (mi & 1) * 8 + r8) * kLdP + (pb0 + (g0 + g) * kWpt) * kCW;
            if constexpr (kNB == 2)
              ldsm_x4_t(bf[g], xp + (mi >> 1) * 8);
            else
              ldsm_x2_t(bf[g], xp);
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
#pragma unroll
            for (int n = 0; n < kNB; ++n) mma(acc[g][n], mf[kb], bf[g][2 * n], bf[g][2 * n + 1]);
        }
        // + D x, one rounding, the rows inside the sequence
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            const int p = (pb0 + (g0 + g) * kWpt) * kCW + n * 8 + 2 * tq;
            const float2 xa = unpack(*reinterpret_cast<const uint32_t*>(xh + ra * kLdP + p));
            const float2 xb = unpack(*reinterpret_cast<const uint32_t*>(xh + rb * kLdP + p));
            if (ra < rows)
              *reinterpret_cast<uint32_t*>(yg + ra * x_row + p) =
                  pack(acc[g][n][0] + dh * xa.x, acc[g][n][1] + dh * xa.y);
            if (rb < rows)
              *reinterpret_cast<uint32_t*>(yg + rb * x_row + p) =
                  pack(acc[g][n][2] + dh * xb.x, acc[g][n][3] + dh * xb.y);
          }
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if (hl + 2 < hb.n) {
      stage_x(hl + 2);
      stage_state(hl + 2);
    }
    cp_async_commit();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int Q, int N, int P>
cudaError_t launch_scan(const dim3& blocks, const bf16* x, const float* dt, const float* A,
                        const bf16* Bm, const bf16* Cm, const float* D, const bf16* ins, bf16* y,
                        const Shape& s, cudaStream_t stream) {
  const size_t smem = Smem<Q, N>::scan(P);
  cudaError_t e = allow_smem(ssd_tc_scan_kernel<Q, N, P>, smem);
  if (e != cudaSuccess) return e;
  // programmatic serialization: its prologue overlaps the end of pass 2
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = blocks;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_tc_scan_kernel<Q, N, P>, x, dt, A, Bm, Cm, D, ins, y, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int Q, int N>
cudaError_t launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
                   const float* D, bf16* y, float* state, float* states, bf16* ins, float* decay,
                   int batch, const Shape& s, cudaStream_t stream) {
  const int per_group = s.n_heads / s.n_groups;
  const dim3 blocks(s.n_chunks, s.n_groups * ((per_group + s.head_block - 1) / s.head_block), batch);
  cudaError_t e;

  const size_t smem1 = Smem<Q, N>::states(s.head_dim, s.head_block);
  if ((e = allow_smem(ssd_tc_states_kernel<Q, N>, smem1)) != cudaSuccess) return e;
  ssd_tc_states_kernel<Q, N><<<blocks, kThreads, smem1, stream>>>(x, dt, A, Bm, states, decay, s);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int pn = s.head_dim * N;
  const dim3 pass_grid((pn / 4 + kPassThreads - 1) / kPassThreads, s.n_heads, batch);
  ssd_tc_pass_kernel<<<pass_grid, kPassThreads, 0, stream>>>(states, decay, ins, state,
                                                             s.n_chunks, s.n_heads, pn);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  switch (s.head_dim) {
    case 8: return launch_scan<Q, N, 8>(blocks, x, dt, A, Bm, Cm, D, ins, y, s, stream);
    case 16: return launch_scan<Q, N, 16>(blocks, x, dt, A, Bm, Cm, D, ins, y, s, stream);
    case 32: return launch_scan<Q, N, 32>(blocks, x, dt, A, Bm, Cm, D, ins, y, s, stream);
    case 64: return launch_scan<Q, N, 64>(blocks, x, dt, A, Bm, Cm, D, ins, y, s, stream);
    case 128: return launch_scan<Q, N, 128>(blocks, x, dt, A, Bm, Cm, D, ins, y, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype must be 1 (bfloat16 x, B, C and y): float32 is ssd.cu's.  dt, A, D
// and the final state are float32; D and state may be null.  The scratch
// (allocated by the caller): states (B, ceil(S/Q), H, P, N) float32, ins the
// same shape in bfloat16, decay (B, ceil(S/Q), H) float32.  Tensors are
// contiguous and 16-byte aligned; the Python wrapper checks them.
extern "C" int repro_ssd_tc_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* D, void* y, void* state, void* states,
                                void* ins, void* decay, int dtype, int batch, int seq, int n_heads,
                                int head_dim, int n_groups, int state_dim, int chunk,
                                void* stream) {
  if (dtype != 1 || batch <= 0 || seq <= 0 || n_heads <= 0 || n_groups <= 0 ||
      n_heads % n_groups != 0 ||
      (head_dim != 8 && head_dim != 16 && head_dim != 32 && head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  Shape s{seq, n_heads, head_dim, n_groups, (seq + chunk - 1) / chunk, 1};
  // the largest head block that still gives every SM a block: C . B^T and
  // B are shared by more heads, and short sequences keep the card busy
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int per_group = n_heads / n_groups;
  for (int hb = kMaxHeadBlock; hb > 1; hb /= 2)
    if ((long long)batch * s.n_chunks * n_groups * ((per_group + hb - 1) / hb) >= sms) {
      s.head_block = hb;
      break;
    }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const bf16* bb = static_cast<const bf16*>(Bm);
  const bf16* cb = static_cast<const bf16*>(Cm);
  const float* df = static_cast<const float*>(D);
  bf16* yb = static_cast<bf16*>(y);
  float* sf = static_cast<float*>(state);
  float* scr = static_cast<float*>(states);
  bf16* inb = static_cast<bf16*>(ins);
  float* dec = static_cast<float*>(decay);
#define SSD_TC_LAUNCH(QQ, NN) \
  return (int)launch<QQ, NN>(xb, dtf, af, bb, cb, df, yb, sf, scr, inb, dec, batch, s, st)
  if (chunk == 64 && state_dim == 128) SSD_TC_LAUNCH(64, 128);
  if (chunk == 64 && state_dim == 16) SSD_TC_LAUNCH(64, 16);
  if (chunk == 32 && state_dim == 128) SSD_TC_LAUNCH(32, 128);
  if (chunk == 32 && state_dim == 16) SSD_TC_LAUNCH(32, 16);
#undef SSD_TC_LAUNCH
  return (int)cudaErrorInvalidValue;
}
