// Blocked attention forward on Hopper's tensor cores (sm_90a), bfloat16.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (the TPU kernel, body `_kernel`) for bfloat16 q, k, v; float32 goes to the
// exact FMA kernel of flash_attention.cu (the Python wrapper picks the
// library by dtype, and this library takes bfloat16 only).  Same function:
// q (B,Sq,H,D) against k, v (B,Sk,K,D), GQA head h -> KV head h / (H/K),
// causal and sliding-window masks on absolute positions shifted by q_offset,
// masked scores -1e30, f32 running max m / sum l / accumulator, l clamped at
// 1e-30, output in bfloat16.  The one numerics change against the FMA kernel:
// the probabilities P are rounded to bfloat16 before the P.V product, as
// every tensor-core flash attention does; the plain version
// (ref.naive_attention) rounds them to v's dtype at the same place.
//
// What bounds it on this card: at OLMo-1B's prefill shape (B=1, H=K=16,
// D=128, S=1024, causal) the function must move q, k, v and o once (16.8 MB,
// 5.0 us at 3.35 TB/s) and do 4*D FLOPs per unmasked (q, k) pair (4.3 GFLOP,
// 4.4 us at 989 TFLOP/s): bytes, narrowly; the two products decide how
// close it gets.
//
// Design.  One CUDA block owns one (b, h, q-tile of BQ rows); the causal
// q-tiles are scheduled heaviest first.  The block has BQ/64 consumer
// warpgroups (one per 64 query rows) and one producer warpgroup, which
// gives its registers to the consumers (setmaxnreg):
//   * one producer thread loads the Q tile once and then the K and V tiles
//     through TMA (cuTensorMapEncodeTiled maps over the (B,S,heads,D)
//     tensors, passed as __grid_constant__ parameters) into a ring of
//     kStages stages in dynamic shared memory; each load completes on an
//     mbarrier, and the producer refills a K (V) stage once every consumer
//     warp has released it (a k_empty / v_empty mbarrier), so the next K
//     tile is in flight while the current one is still being used for P.V;
//   * each consumer warpgroup computes S = Q.K^T with wgmma m64n{BKV}k16
//     (both operands in shared memory, K-major, swizzled as TMA wrote them),
//     runs the online softmax on the f32 accumulator in registers (a row's
//     max and sum reduce over the 4 threads that hold it), converts P to
//     bfloat16 in place into wgmma's A-fragment layout and accumulates
//     O += P.V with wgmma m64n{D}k16 (A from registers, V MN-major in
//     shared memory).  The products of tile i are issued together with the
//     P.V of tile i-1, and the softmax of S_i runs while that P.V does.
// Rows and columns are read off the accumulator's own layout: thread t of a
// warpgroup holds rows 16*(t/32) + (t%32)/4 and that + 8, and in each
// 8-column block the columns 2*(t%4) and 2*(t%4) + 1.  KV tiles wholly
// masked for the block are never loaded; a warpgroup skips the products of
// a tile wholly masked for its own rows (it still waits for and releases
// the stage).  Only a tile with a masked key runs the mask pass.  TMA fills
// rows past Sq or Sk with zeros, and the mask drops keys past Sk; rows past
// Sq are not stored.
//
// Code size is a cost of its own here: each step of the loop has one call
// site, because the unrolled body of every instance is executed from the
// instruction cache by all its warps (a copy of the loop for the first
// tile, and a per-element mask on every tile, made the kernel 30% slower).
//
// Shared memory: each tile (Q, and K and V per stage) is D/C column blocks
// of [rows][C] elements, C = min(D, 64), one row of C bf16 = the swizzle
// width (128, 64 or 32 bytes for D >= 64, 32, 16), every block aligned to
// 1024 bytes so TMA's swizzle and the wgmma descriptors' agree.
//
// Entry points (plain C, called through ctypes):
// repro_flash_attention_tc_fwd launches on the caller's stream and returns
// cudaGetLastError(); repro_flash_attention_tc_smem_bytes gives an
// instance's dynamic shared memory, which the Python wrapper holds against
// its own table.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int BQ, int BKV, int D>
struct Cfg {
  static constexpr int kConsumers = BQ / 64;                    // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * 128;       // + the producer warpgroup
  // Registers a thread: at launch (65536 per SM over the resident blocks'
  // threads), then moved from the producer to the consumers by setmaxnreg.
  static constexpr int kBlocksPerSm = kConsumers == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 1 ? 232 : 240;
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;    // bytes of one row of a column block
  static constexpr int kCols = kSwizzle / 2;                    // elements of one row of a column block
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kKVBytes = BKV * D * 2;                  // one K or V tile
  static constexpr int kBarrierBytes = 128;                     // 1 + 4 * kStages mbarriers
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + kBarrierBytes;
  static_assert(BQ % 64 == 0 && BKV % 16 == 0 && D % 16 == 0, "tile shapes");
  static_assert(8 * (1 + 4 * kStages) <= kBarrierBytes, "barrier space");
};

struct Params {
  int sq, sk, n_heads, n_kv, causal, window, q_offset;
  float scale_log2;  // softmax scale * log2(e): scores are kept in base-2 units
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// One box of the (B, S, heads, D) tensor: coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

__host__ __device__ constexpr uint32_t swizzle_mode(int bytes) { return bytes == 128 ? 1 : bytes == 64 ? 2 : 3; }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A.B, A (64 x 16) and B (16 x N) both from shared memory, B K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// d += A.B, A (64 x 16, bf16 pairs) from registers, B (16 x N) MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A thread holds BKV/4 values of each of its two rows: value j of row r is
// register 4*(j/2) + 2*r + j%2, at tile column col0 + o(j), o(j) = 8*(j/2) +
// j%2.  below(x) has bit j set where o(j) < x.
__device__ __forceinline__ uint32_t below(int x) {
  const int n = x <= 0 ? 0 : min(2 * ((x - 1) >> 3) + min(((x - 1) & 7) + 1, 2), 32);
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// Scales one tile's scores to base 2 and masks them, for a tile with a
// masked key: scores outside the causal or window bound become -1e30, as in
// the reference, and keys past the sequence end -inf, so that they add
// nothing even to a row whose keys so far are all masked (there exp2(-1e30 -
// m) is exp2(0) = 1).  Each bound is one bit mask a row.
template <int BKV>
__device__ __forceinline__ void scale_and_mask(float (&s)[BKV / 2], const Params& p, int k0,
                                               int qpos0, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    // keys k0 + c are inside both bounds for c in [c_lo, c_hi], and exist for c < c_end
    const int c_hi = (p.causal ? qpos : INT_MAX / 2) - k0;
    const int c_lo = (p.window > 0 ? qpos - p.window + 1 : INT_MIN / 2) - k0;
    const uint32_t inside = below(c_hi - col0 + 1) & ~below(c_lo - col0);
    const uint32_t exists = below(p.sk - k0 - col0);
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      float& t = s[4 * (j / 2) + 2 * r + j % 2];
      t = (inside >> j) & 1u ? t * p.scale_log2 : kNegInf;
      t = (exists >> j) & 1u ? t : __int_as_float(0xff800000);  // -inf
    }
  }
}

// One tile's online softmax on the S accumulator, in base 2: the scores are
// first multiplied by `scale` (the softmax scale in base 2, or 1 where
// scale_and_mask already applied it).  Scores become probabilities in
// place, m and this thread's share of l are updated, and alpha[r] =
// exp2(m_old - m_new) is returned for the caller to rescale O.
template <int BKV>
__device__ __forceinline__ void online_softmax(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      float& t = s[4 * (j / 2) + 2 * r + j % 2];
      t *= scale;
      mx = fmaxf(mx, t);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = ex2(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      float& t = s[4 * (j / 2) + 2 * r + j % 2];
      t = ex2(t - m_new);
      sum += t;
    }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(Cfg<BQ, BKV, D>::kThreads, Cfg<BQ, BKV, D>::kBlocksPerSm)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ o, const Params p) {
  using C = Cfg<BQ, BKV, D>;
  constexpr uint32_t kMode = swizzle_mode(C::kSwizzle);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + C::kQBytes;                  // stage s at + s * kKVBytes
  const uint32_t v_s = k_s + kStages * C::kKVBytes;
  const uint32_t bars = v_s + kStages * C::kKVBytes;
  // mbarriers: Q loaded; per stage K and V loaded, K and V released by every consumer warp
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal q-tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.n_heads / p.n_kv);
  // KV tiles that hold any unmasked key for this q-tile.
  const int q_first = p.q_offset + q0;
  const int q_last = q_first + min(BQ, p.sq - q0) - 1;
  const int n_tiles = (p.sk + BKV - 1) / BKV;
  const int kt_end = p.causal ? min(n_tiles, q_last / BKV + 1) : n_tiles;
  const int kt_begin = p.window > 0 ? max(0, q_first - p.window + 1) / BKV : 0;
  const int n_iter = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * C::kConsumers);
      mbar_init(v_empty(s), 4 * C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  auto stage = [](int i) { return i % kStages; };
  auto parity = [](int i) { return (uint32_t)((i / kStages) & 1); };
  if (warp >= 4 * C::kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::kProducerRegs));
    if (warp == 4 * C::kConsumers && lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < D / C::kCols; ++c)
        tma_load(q_s + c * BQ * C::kSwizzle, &q_map, q_full, c * C::kCols, h, q0, b);
      for (int i = 0; i < n_iter; ++i) {
        const int s = stage(i);
        const int k0 = (kt_begin + i) * BKV;
        if (i >= kStages) mbar_wait(k_empty(s), parity(i) ^ 1);
        mbar_expect_tx(k_full(s), C::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / C::kCols; ++c)
          tma_load(k_s + s * C::kKVBytes + c * BKV * C::kSwizzle, &k_map, k_full(s), c * C::kCols,
                   kh, k0, b);
        if (i >= kStages) mbar_wait(v_empty(s), parity(i) ^ 1);
        mbar_expect_tx(v_full(s), C::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / C::kCols; ++c)
          tma_load(v_s + s * C::kKVBytes + c * BKV * C::kSwizzle, &v_map, v_full(s), c * C::kCols,
                   kh, k0, b);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int row0 = 16 * (warp % 4) + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane % 4);              // and columns col0, col0 + 1 of each 8
  const int wg_q0 = q0 + 64 * wg;
  const int wg_rows = min(64, p.sq - wg_q0);    // <= 0: every row of the warpgroup is padding
  const int wg_first = p.q_offset + wg_q0;
  const int wg_last = wg_first + wg_rows - 1;
  // The tiles with an unmasked key for this warpgroup: the causal bound ends
  // them and the window starts them, so they are one interval [lo, hi).
  auto live = [&](int i) {
    const int k0 = (kt_begin + i) * BKV;
    return wg_rows > 0 && (!p.causal || k0 <= wg_last) &&
           (p.window <= 0 || wg_first - (k0 + BKV - 1) < p.window);
  };
  auto full = [&](int i) {  // no key of the tile masked for any row of the warpgroup
    const int k0 = (kt_begin + i) * BKV;
    return k0 + BKV <= p.sk && (!p.causal || k0 + BKV - 1 <= wg_first) &&
           (p.window <= 0 || wg_last - k0 < p.window);
  };
  int lo = 0, hi = n_iter;
  while (lo < hi && !live(lo)) ++lo;
  while (hi > lo && !live(hi - 1)) --hi;
  // Each warp releases a stage once it is past the stage's wait (and, for a
  // live tile, once the products that read it are complete).
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  auto pass = [&](int i) {  // a tile wholly masked for this warpgroup
    mbar_wait(k_full(stage(i)), parity(i));
    release(k_empty(stage(i)));
    mbar_wait(v_full(stage(i)), parity(i));
    release(v_empty(stage(i)));
  };
  // S = Q.K^T, K-major operands: k-step kk reads columns 16kk.. of column
  // block 16kk / kCols, 32 bytes further into the swizzled row per step.
  auto issue_qk = [&](float (&sacc)[BKV / 2], int i) {
    const int s = stage(i);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t blk = (kk * 16) / C::kCols, off = ((kk * 16) % C::kCols) * 2;
      const uint64_t da = make_desc(q_s + blk * BQ * C::kSwizzle + wg * 64 * C::kSwizzle + off,
                                    16, 8 * C::kSwizzle, kMode);
      const uint64_t db = make_desc(k_s + s * C::kKVBytes + blk * BKV * C::kSwizzle + off, 16,
                                    8 * C::kSwizzle, kMode);
      wgmma_ss<BKV>(sacc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P.V, V MN-major: k-step kk reads V rows 16kk..16kk+15; the column
  // blocks of 64 are BKV rows apart (LBO), groups of 8 rows one swizzle atom
  // apart (SBO).
  auto issue_pv = [&](float (&acc)[D / 2], const uint32_t (&pa)[BKV / 16][4], int i) {
    const int s = stage(i);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db = make_desc(v_s + s * C::kKVBytes + kk * 16 * C::kSwizzle,
                                    BKV * C::kSwizzle, 8 * C::kSwizzle, kMode);
      wgmma_rs<D>(acc, pa[kk], db);
    }
    wgmma_commit();
  };
  // P to bf16 A fragments: k-step kk covers S columns 16kk..16kk+15, i.e.
  // accumulator blocks 2kk (registers 8kk..8kk+3) and 2kk+1 (8kk+4..8kk+7).
  auto to_fragments = [](uint32_t (&pa)[BKV / 16][4], const float (&sacc)[BKV / 2]) {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 two = __floats2bfloat162_rn(sacc[8 * kk + 2 * j], sacc[8 * kk + 2 * j + 1]);
        pa[kk][j] = *reinterpret_cast<uint32_t*>(&two);
      }
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float sacc[BKV / 2];
  uint32_t pa[BKV / 16][4];
  const int qpos0 = wg_first + row0;

  mbar_wait(q_full, 0);
  for (int i = 0; i < lo; ++i) pass(i);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;  // P of "tile lo - 1": zeros
  // Per live tile i: S_i = Q.K_i^T and O += P_{i-1}.V_{i-1} in flight together
  // (at i = lo, P is zero and V is tile lo's own, so the product adds
  // nothing); the softmax of S_i runs while the P.V product does.  One call
  // site of each step keeps the unrolled body small.
  for (int i = lo; i < hi; ++i) {
    const int prev = i > lo ? i - 1 : i;
    mbar_wait(k_full(stage(i)), parity(i));
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) sacc[j] = 0.f;
    wgmma_fence();
    issue_qk(sacc, i);
    mbar_wait(v_full(stage(prev)), parity(prev));
    issue_pv(acc, pa, prev);
    wgmma_wait<1>();  // S_i is complete, the P.V product may still run
    fence_regs(sacc);
    release(k_empty(stage(i)));
    const bool masked = !full(i);
    if (masked) scale_and_mask<BKV>(sacc, p, (kt_begin + i) * BKV, qpos0, col0);
    online_softmax<BKV>(sacc, m, l, alpha, masked ? 1.f : p.scale_log2);
    wgmma_wait<0>();  // P_{i-1}.V_{i-1} is complete: its registers and stage are free
    fence_regs(acc);
    if (i > lo) release(v_empty(stage(i - 1)));
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    to_fragments(pa, sacc);
  }
  if (lo < hi) {  // the last tile's P.V
    mbar_wait(v_full(stage(hi - 1)), parity(hi - 1));
    wgmma_fence();
    issue_pv(acc, pa, hi - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(v_empty(stage(hi - 1)));
  }
  for (int i = hi; i < n_iter; ++i) pass(i);

  // Epilogue: the row sums reduce over the 4 threads of a row; divide by
  // max(l, 1e-30) and store the rows inside the sequence as bf16 pairs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = wg_q0 + row0 + 8 * r;
    if (row >= p.sq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* out = o + (((size_t)b * p.sq + row) * p.n_heads + h) * D + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, reached through the CUDA
// runtime: the library links no libcuda of its own.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                    : nullptr;
  }();
  return fn;
}

// A map of a contiguous (batch, seq, heads, D) bf16 tensor whose box is one
// column block of `rows` rows of one head, swizzled as the descriptors read it.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int rows) {
  constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(kSwizzle / 2), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = kSwizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BQ, int BKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int sq, int sk,
                   int n_heads, int n_kv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using C = Cfg<BQ, BKV, D>;
  auto kern = flash_attention_tc_kernel<BQ, BKV, D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map<D>(&q_map, q, batch, sq, n_heads, BQ) || !make_map<D>(&k_map, k, batch, sk, n_kv, BKV) ||
      !make_map<D>(&v_map, v, batch, sk, n_kv, BKV))
    return cudaErrorInvalidValue;
  const Params p{sq, sk, n_heads, n_kv, causal, window, q_offset, scale * kLog2e};
  const dim3 grid((sq + BQ - 1) / BQ, n_heads, batch);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(q_map, k_map, v_map,
                                                static_cast<__nv_bfloat16*>(o), p);
  return cudaGetLastError();
}

template <int BQ, int BKV>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int batch,
                       int sq, int sk, int n_heads, int n_kv, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<BQ, BKV, 16>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    case 32: return launch<BQ, BKV, 32>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    case 64: return launch<BQ, BKV, 64>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    case 128: return launch<BQ, BKV, 128>(q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BQ, int BKV>
long long smem_d(int d) {
  switch (d) {
    case 16: return (long long)Cfg<BQ, BKV, 16>::kSmem;
    case 32: return (long long)Cfg<BQ, BKV, 32>::kSmem;
    case 64: return (long long)Cfg<BQ, BKV, 64>::kSmem;
    case 128: return (long long)Cfg<BQ, BKV, 128>::kSmem;
    default: return -1;
  }
}

}  // namespace

// Tensors are contiguous bf16 (B,S,heads,D), 16-byte aligned; the Python
// wrapper checks both before the call.  block_q, block_kv in {64, 128}.
extern "C" int repro_flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                            int batch, int sq, int sk, int n_heads, int n_kv,
                                            int d, int causal, int window, int q_offset,
                                            float scale, int block_q, int block_kv, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_kv == 64)
    return (int)dispatch_d<64, 64>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  if (block_q == 64 && block_kv == 128)
    return (int)dispatch_d<64, 128>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  if (block_q == 128 && block_kv == 64)
    return (int)dispatch_d<128, 64>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  if (block_q == 128 && block_kv == 128)
    return (int)dispatch_d<128, 128>(d, q, k, v, o, batch, sq, sk, n_heads, n_kv, causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one instance in bytes, -1 where none is compiled.
extern "C" long long repro_flash_attention_tc_smem_bytes(int block_q, int block_kv, int d) {
  if (block_q == 64 && block_kv == 64) return smem_d<64, 64>(d);
  if (block_q == 64 && block_kv == 128) return smem_d<64, 128>(d);
  if (block_q == 128 && block_kv == 64) return smem_d<128, 64>(d);
  if (block_q == 128 && block_kv == 128) return smem_d<128, 128>(d);
  return -1;
}
