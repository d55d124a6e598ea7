// FF matrix product by the Ozaki slice-pair scheme on Hopper's fp16 tensor
// cores: the exact slice-pair block products run as wgmma, fed by TMA, and
// are folded into a float-float accumulator in registers.
//
// Replaces the TPU kernel src/repro/kernels/ff_matmul.py::ff_matmul_ozaki
// (_ff_matmul_ozaki_kernel).  The bits are those of its plain version,
// kernels/ff_matmul.py::ozaki_accumulate_plain: for each K-block of bk, for
// each kept slice pair (i, j) in table order, the block product of slice i
// of A and slice j of B, folded with Add212 (TwoSum, one add, Fast2Sum).
//
// Why fp16 tensor cores give those bits.  Slice i of a row is w = q 2^g with
// an integer |q| <= 2^(beta-1) and g = ie + 1 - beta (i + 1) (ie: the row's
// ceil(log2 max|x|); ozaki_operands in kernels/ff_matmul.py builds q, g).
// ozaki_params admits beta <= 12 (2 beta + ceil(log2 bk) <= 26), so q has
// at most 11 bits: exact in fp16.  Within one (K-block, pair, row, column)
// every product shares the scale 2^(ga + gb) and the integer block sum
// S = sum qa qb is at most 2^24, so the tensor cores' f32 accumulation of
// it is exact in any order.  The kernel scales S by 2^(ga + gb) and folds
// it in table order: the plain version's f32 GEMM of the slices gives the
// same value wherever the products' quantum 2^(ga + gb) is at least 2^-149
// (below that, and for slices that _sigma flushed, the port's
// flush-to-zero policy applies).  The scaling: where every ga of the
// block's rows is in [-126, 103] and every gb of its columns in
// [-126, 127], as (S 2^ga) 2^gb, two exact multiplies; elsewhere as
// (S 2^(e >> 1)) 2^(e - (e >> 1)), e = ga + gb, whose factors and
// intermediate stay normal wherever the product is.  Never one factor
// 2^(ga + gb), which can leave the range where the product does not.
//
// What bounds it on this card: the pair products, 2 npairs M N K operations
// on the fp16 tensor cores (989 TFLOP/s), against the fold's 12 f32
// operations per output, K-block and pair on the SIMT lanes (about a third
// of the tensor time at bk = 512) and the fp16 operand bytes (less than a
// third).  Design (Shipped below):
//   * Warp specialised: warpgroup 0 produces (one thread issues the TMA
//     loads into a ring of 9 stages, mbarriers full/empty, in the order the
//     consumer reads them: K-block, pair, K tile); one consumer warpgroup
//     owns 64 x 128 outputs: a fresh f32 wgmma accumulator (m64n128k16,
//     f16 inputs, qa and qb both K-major, 128-byte swizzled) and the FF
//     (hi, lo), all in its registers (~230 a thread, none spilled).
//   * Per K-block and pair, the consumer runs the block product over the
//     block's K tiles of 64, three tiles' wgmma groups in flight, releasing
//     each stage when the group reading it is done; then scales and folds
//     with the block's exponents, staged in shared memory at the start.
//   * The other layouts Config takes, built for measuring by
//     benchmarks/ozaki_variants.py (a text edit of Shipped):
//     two consumers a block, 64 x 128 each, a ring each and taking turns on
//     the tensor cores (ping-pong: one folds while the other's wgmma runs),
//     or without turns, or sharing one ring of 128-row stages (half the
//     operand traffic); and one consumer issuing its own loads, two blocks
//     an SM.  With two consumers the 192 registers of accumulator and FF
//     state do not fit beside the rest: setmaxnreg's 232 leave them
//     spilling, and each runs slower than the default.
// Where trouble lies:
//   * The fold order is fixed, the products are not: K is never split
//     across blocks (that would reorder the folds); a block walks its
//     tile's K-blocks and pairs in table order.  At (512, 8192, 2048) that
//     leaves 128 blocks of 64 x 128 for 132 SMs.
//   * A K-block edge inside a K tile: ozaki_operands pads every K-block to
//     a multiple of 64 in the operands' layout (each block's tail is zero),
//     so a tile never straddles two blocks and the number of blocks is
//     unchanged.
//   * Budget-edge sums (every |q| = 2^(beta-1), products of one sign) reach
//     bk 2^(2 beta - 2) <= 2^24 exactly: chip_smoke.py checks them bit for
//     bit and against float64 at beta 8 and 12.
//   * Subnormal slices: the port's _sigma flushes below 2^-126, so a slice
//     of a tiny row is the unrounded remainder, which fp16 rounds; the
//     plain version's f32 products round there too, differently.
//     chip_smoke.py counts such outputs.
//   * A lost TMA or barrier would hang: every mbarrier wait traps after
//     2^24 polls, so a fault ends as a launch error, not a hang.
// The tensor-map encoder comes from the runtime (cudaGetDriverEntryPoint),
// so the library needs no link against libcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ff_eft.cuh"

namespace {

constexpr int kMaxPairs = 256;  // = OZAKI_MAX_PAIRS in kernels/ff_matmul.py
constexpr int kMaxBeta = 12;    // = OZAKI_MAX_BETA: |q| <= 2^11, exact fp16
constexpr int kTileK = 64;      // = OZAKI_TILE_K: K per stage (128 B of fp16)
constexpr int kTileN = 128;     // = OZAKI_TILE_N: output columns per block
constexpr int kWgRows = 64;     // output rows per consumer warpgroup
constexpr int kBBytes = kTileN * kTileK * 2;   // a stage's qb tile: 16 KB
constexpr int kSmemPerSm = 228 * 1024;    // shared memory of an SM
constexpr int kSmemPerBlock = 227 * 1024; // the most a block may have
constexpr int kExpSlices = 8;   // slices whose exponents a block stages
constexpr int kInFlight = 3;    // K tiles whose wgmma groups may be in flight

static_assert((1 << (kMaxBeta - 1)) <= 2048,
              "|q| <= 2^(beta-1) must be an fp16 integer (<= 2^11)");

// The slice-pair table, passed by value with the launch: pair p multiplies
// slice si[p] of A by slice sj[p] of B.
struct PairTable {
  unsigned char si[kMaxPairs], sj[kMaxPairs];
};

struct Args {
  const int* ga;        // (n, M) slice exponents of A's rows
  const int* gb;        // (n, N) slice exponents of B's columns
  float* hi;            // (M, N) outputs
  float* lo;
  int n, M, N, K, bk, bkp, nkb, npairs;
};

// kCons consumer warpgroups a block, each 64 x 128 outputs.  kShared: one
// ring whose stages (A 128 x 64) both consumers read; else a ring each
// (A 64 x 64).  kTurns: the consumers take turns issuing their block
// products (ping-pong).  kInline: no producer warpgroup, the consumer's
// first thread issues the loads as stages come free, and an SM holds two
// blocks.
template <int kCons, bool kShared, bool kTurns, bool kInline>
struct Config {
  static constexpr int kConsumers = kCons;
  static constexpr bool kSharedRing = kShared, kTakeTurns = kTurns,
                        kInlineLoads = kInline;
  static constexpr int kRings = kShared ? 1 : kCons;
  static constexpr int kRingRows = kShared ? kCons * kWgRows : kWgRows;
  static constexpr int kABytes = kRingRows * kTileK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBlocksPerSm = kInline ? 2 : 1;
  static constexpr int kThreads = 128 * (kCons + (kInline ? 0 : 1));
  static constexpr int kRows = kWgRows * kCons;
  // the block's exponents: ga (kRows) and gb (kTileN) of kExpSlices
  // slices, and a flag a slice each, 1 where its scale factors are normal
  static constexpr int kExpWords = kExpSlices * (kRows + kTileN + 2);
  static constexpr int kStages =
      (kSmemPerSm / kBlocksPerSm - 4096 - 4 * kExpWords) /
      (kRings * kStageBytes);
  static constexpr int kBarBytes = 2 * kRings * kStages * 8;
  static constexpr int kSmem = kRings * kStages * kStageBytes + kBarBytes +
                               4 * kExpWords + 1024;  // + alignment
  // registers: with two consumers, the block's 168 a thread moved from the
  // producer warpgroup (40) to the consumers (232); otherwise 255 a thread
  // as compiled
  static constexpr bool kMoveRegs = kCons == 2;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      ((65536 / kThreads / 8 * 8) * kThreads - 128 * kProducerRegs) /
      (128 * kCons) / 8 * 8;
  static_assert(kStages >= 2, "at least two stages a ring");
  static_assert(kSmem <= kSmemPerBlock, "shared memory of a block");
  static_assert(!kMoveRegs || kConsumerRegs <= 256, "setmaxnreg: <= 256");
  static_assert(!kInline || (kCons == 1 && !kShared && !kTurns),
                "loads inline: one consumer");
};

// The kernel's layout: a producer warpgroup and one consumer of 64 x 128.
// (Two consumers: Config<2, false, true, false> with turns, <2, false,
// false, false> without, <2, true, false, false> sharing one ring; one
// consumer issuing its own loads: <1, false, false, true>.)
using Shipped = Config<1, false, false, false>;

// -- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  Traps
// after 2^24 polls: a lost copy or arrival ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// The consumers' turns (ping-pong): named barrier 1 + c is consumer c's
// turn; its 256 threads are c's waiting and the other consumer's arrival.
__device__ __forceinline__ void turn_wait(int cw) {
  if (cw == 0) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
  }
}

__device__ __forceinline__ void turn_give(int cw) {   // to the other one
  if (cw == 0) {
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  } else {
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving accesses of the accumulator across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) B (16 x 128, MN-major), f16 in, f32 out;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// 2^e for integer e in [-126, 127], from the exponent bits.
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// Synchronise the consumer warpgroups (named barrier 3).
template <int kThreadsSync>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kThreadsSync) : "memory");
}

// S 2^e, exactly wherever the result is normal: S times 2^(e >> 1), then
// times 2^(e - (e >> 1)), each factor a normal power of two built from its
// exponent bits.  e >= -252 keeps both factors normal; below that the
// product of an integer S < 2^24 is 0 either way, and e <= 242 always
// (ga, gb <= 121).
__device__ __forceinline__ float scale_pow2(float s, int e) {
  e = max(e, -252);
  const int h = e >> 1;
  const float f1 = __int_as_float((h + 127) << 23);
  const float f2 = __int_as_float((e - h + 127) << 23);
  return ffk::mul(ffk::mul(s, f1), f2);
}

// -- the kernel -----------------------------------------------------------------

// The loads in the consumers' order: K-block, pair, K tile; s, ph: the
// stage they go to and its phase.
struct Cursor {
  int kb = 0, p = 0, t = 0, s = 0;
  uint32_t ph = 0;
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kBlocksPerSm)
ozaki_kernel(const __grid_constant__ CUtensorMap tma_a,
             const __grid_constant__ CUtensorMap tma_b,
             const __grid_constant__ PairTable pairs,
             const __grid_constant__ Args args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kRings * C::kStages * C::kStageBytes;
  int* const exps = reinterpret_cast<int*>(
      smem_raw + (bars + C::kBarBytes - smem_u32(smem_raw)));
  // stage s of ring r: the qa tile (kRingRows x 64), then the qb tile
  // (128 x 64)
  auto stage = [&](int r, int s) {
    return base + static_cast<uint32_t>((r * C::kStages + s) * C::kStageBytes);
  };
  auto full = [&](int r, int s) {
    return bars + static_cast<uint32_t>(8 * (r * C::kStages + s));
  };
  auto empty = [&](int r, int s) {
    return bars + static_cast<uint32_t>(8 * ((C::kRings + r) * C::kStages + s));
  };
  if (threadIdx.x == 0) {
    for (int r = 0; r < C::kRings; ++r) {
      for (int s = 0; s < C::kStages; ++s) {
        mbar_init(full(r, s), 1);
        // every warp of the ring's consumers arrives once it has read a stage
        mbar_init(empty(r, s), C::kSharedRing ? 4 * C::kConsumers : 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * C::kRows, n0 = blockIdx.y * kTileN;
  auto tiles = [&](int kb) {
    return (min(args.bk, args.K - kb * args.bk) + kTileK - 1) / kTileK;
  };
  // wait for the cursor's stage of ring r to be free, load it, advance
  auto load = [&](Cursor& c, int r) {
    mbar_wait(empty(r, c.s), c.ph ^ 1);
    const int k = c.kb * args.bkp + c.t * kTileK;
    const int i = pairs.si[c.p], j = pairs.sj[c.p];
    const uint32_t a = stage(r, c.s), b = a + C::kABytes, bar = full(r, c.s);
    mbar_expect_tx(bar, C::kStageBytes);
    tma_load_3d(a, &tma_a, bar, k, m0 + (C::kSharedRing ? 0 : r * kWgRows),
                i);
    tma_load_3d(b, &tma_b, bar, k, n0, j);
    if (++c.t == tiles(c.kb)) {
      c.t = 0;
      if (++c.p == args.npairs) {
        c.p = 0;
        ++c.kb;
      }
    }
    if (++c.s == C::kStages) {
      c.s = 0;
      c.ph ^= 1;
    }
  };

  if (!C::kInlineLoads && wg == 0) {
    // ---- producer: one thread a ring issues the TMA loads ----
    if (C::kMoveRegs) regs_dec<C::kProducerRegs>();
    const int r = threadIdx.x / 32;
    if (r < C::kRings && threadIdx.x % 32 == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_b))
                   : "memory");
      for (Cursor c; c.kb < args.nkb;) load(c, r);
    }
  } else {
    // ---- consumer warpgroup cw: 64 x 128 outputs ----
    if (C::kMoveRegs) regs_inc<C::kConsumerRegs>();
    const int cw = C::kInlineLoads ? 0 : wg - 1;
    const int r = C::kSharedRing ? 0 : cw;
    const uint32_t a_off = C::kSharedRing ? cw * kWgRows * kTileK * 2 : 0;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    // accumulator fragment: d[4c + h] at row row0 + 8 (h >> 1), column
    // col0 + 8 c + (h & 1)
    const int row0 = m0 + cw * kWgRows + (tid / 32) * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    float acc[64], hi[64], lo[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = hi[e] = lo[e] = 0.0f;

    // the block's exponents into shared memory (up to kExpSlices slices),
    // with a flag a slice: 1 if 2^g is a normal f32 for all its rows (and
    // S 2^ga stays finite, S < 2^24), or columns
    int* const ea_s = exps;
    int* const eb_s = exps + kExpSlices * C::kRows;
    int* const ok_a = eb_s + kExpSlices * kTileN;
    int* const ok_b = ok_a + kExpSlices;
    const bool staged = args.n <= kExpSlices;
    if (staged) {
      const int ct = threadIdx.x - (C::kInlineLoads ? 0 : 128);
      constexpr int kCt = 128 * C::kConsumers;
      if (ct < 2 * kExpSlices) ok_a[ct] = 1;
      consumers_sync<kCt>();
      for (int q = ct; q < args.n * C::kRows; q += kCt) {
        const int sl = q / C::kRows, row = m0 + q % C::kRows;
        const int g = row < args.M ? __ldg(args.ga + static_cast<long long>(sl) * args.M + row) : 0;
        ea_s[q] = g;
        if (g < -126 || g > 103) atomicAnd(ok_a + sl, 0);
      }
      for (int q = ct; q < args.n * kTileN; q += kCt) {
        const int sl = q / kTileN, col = n0 + q % kTileN;
        const int g = col < args.N ? __ldg(args.gb + static_cast<long long>(sl) * args.N + col) : 0;
        eb_s[q] = g;
        if (g < -126 || g > 127) atomicAnd(ok_b + sl, 0);
      }
      consumers_sync<kCt>();
    }

    // loads inline: the first thread keeps every stage loaded, one load
    // for each stage the warpgroup frees
    Cursor ahead;
    if (C::kInlineLoads && tid == 0) {
      for (int q = 0; q < C::kStages && ahead.kb < args.nkb; ++q) {
        load(ahead, 0);
      }
    }
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty(r, s));
      if (C::kInlineLoads && tid == 0 && ahead.kb < args.nkb) load(ahead, 0);
    };

    // the first stage's wgmma descriptors, both operands K-major: rows of
    // 64 K (128 B), 8-row groups 1024 B apart
    const uint64_t desc_a = smem_desc(stage(r, 0) + a_off, 16, 1024);
    const uint64_t desc_b = smem_desc(stage(r, 0) + C::kABytes, 16, 1024);

    if (C::kTakeTurns && cw == 1) turn_give(cw);   // consumer 0 goes first
    int s = 0;
    uint32_t ph = 0;
    for (int kb = 0; kb < args.nkb; ++kb) {
      const int nt = tiles(kb);
      for (int p = 0; p < args.npairs; ++p) {
        if (C::kTakeTurns) turn_wait(cw);
        // stages read by wgmma groups still in flight: `held`, the oldest
        // at `old`
        int held = 0, old = s;
        for (int t = 0; t < nt; ++t) {
          mbar_wait(full(r, s), ph);
          // descriptors: the stage's start address in 16-byte units added
          // to the first stage's; 32 B per 16 K within the 128-byte rows
          const uint64_t dk = static_cast<uint64_t>(
              (s * C::kStageBytes) >> 4);
          wgmma_fence();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < kTileK / 16; ++kk) {
            wgmma_m64n128k16(acc, desc_a + dk + 2 * kk, desc_b + dk + 2 * kk,
                             t > 0 || kk > 0);
          }
          wgmma_commit();
          fence_regs(acc);
          if (++held == kInFlight) {
            wgmma_wait<kInFlight - 1>();   // the oldest group is done
            release(old);
            --held;
            if (++old == C::kStages) old = 0;
          }
          if (++s == C::kStages) {
            s = 0;
            ph ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        for (; held > 0; --held) {
          release(old);
          if (++old == C::kStages) old = 0;
        }
        if (C::kTakeTurns) turn_give(cw);

        // the exact block product, scaled by 2^(ga + gb) and folded
        const int i = pairs.si[p], j = pairs.sj[p];
        const int rl = row0 - m0, cl = col0 - n0;   // in the block's tile
        auto ea = [&](int r) {
          return staged ? ea_s[i * C::kRows + r]
                        : (m0 + r < args.M
                               ? __ldg(args.ga + static_cast<long long>(i) * args.M +
                                       m0 + r)
                               : 0);
        };
        auto eb = [&](int c) {
          return staged ? eb_s[j * kTileN + c]
                        : (n0 + c < args.N
                               ? __ldg(args.gb + static_cast<long long>(j) * args.N +
                                       n0 + c)
                               : 0);
        };
        const int ea0 = ea(rl), ea1 = ea(rl + 8);
        if (staged && ok_a[i] && ok_b[j]) {
          // every factor normal: (S 2^ga) 2^gb, both products exact where
          // the result is normal, as S 2^(ga + gb) below
          const float fa[2] = {pow2f(ea0), pow2f(ea1)};
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const float fb[2] = {pow2f(eb(cl + 8 * c)),
                                 pow2f(eb(cl + 8 * c + 1))};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const float v = ffk::mul(ffk::mul(acc[4 * c + h], fa[h >> 1]),
                                       fb[h & 1]);
              const ffk::ff2 f = ffk::add212({hi[4 * c + h], lo[4 * c + h]}, v);
              hi[4 * c + h] = f.hi;
              lo[4 * c + h] = f.lo;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const int eb0 = eb(cl + 8 * c), eb1 = eb(cl + 8 * c + 1);
            const int e[4] = {ea0 + eb0, ea0 + eb1, ea1 + eb0, ea1 + eb1};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const ffk::ff2 f = ffk::add212({hi[4 * c + h], lo[4 * c + h]},
                                             scale_pow2(acc[4 * c + h], e[h]));
              hi[4 * c + h] = f.hi;
              lo[4 * c + h] = f.lo;
            }
          }
        }
      }
    }
    if (C::kTakeTurns && cw == 0) turn_wait(cw);   // the last turn given

#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int row = row0 + 8 * (h >> 1), col = col0 + 8 * c + (h & 1);
        if (row < args.M && col < args.N) {
          const long long o = static_cast<long long>(row) * args.N + col;
          args.hi[o] = hi[4 * c + h];
          args.lo[o] = lo[4 * c + h];
        }
      }
    }
  }
}

// -- host ----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D fp16 tensor map (dims innermost first), 128-byte swizzle, zero fill
// outside the tensor.
bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
                uint64_t d2, uint32_t b0, uint32_t b1) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C>
int launch(const void* qa, const void* qb, int n, int Kp, int Np,
           const PairTable& pairs, const Args& args, cudaStream_t stream) {
  auto kernel = ozaki_kernel<C>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    // all of the SM's unified memory as shared memory: room for
    // kBlocksPerSm blocks
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, qa, Kp, args.M, n, kTileK, C::kRingRows) ||
      !tensor_map(&mb, qb, Kp, Np, n, kTileK, kTileN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((args.M + C::kRows - 1) / C::kRows,
                  (args.N + kTileN - 1) / kTileN);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(ma, mb, pairs, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The pair accumulation of the Ozaki FF matmul (kernels/ff_matmul.py,
// ozaki_operands and ozaki_accumulate):
//   qa (n, M, Kp) and qb (n, Np, Kp) fp16 slices as integers (B's
//     transposed), contiguous, Kp a multiple of 8, Np >= N rows of qb;
//     K-block kb at [kb bkp, kb bkp + bk) of Kp,
//     bkp a multiple of 64, zero past each block's end;
//   ga (n, M), gb (n, N) int32: slice i of row m is qa[i, m] 2^ga[i, m];
//   si, sj: host arrays of the npairs (<= 256) kept pairs in fold order;
//   out_hi, out_lo (M, N) f32 contiguous; K, bk: the unpadded K and block.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ff_matmul_ozaki_f16(const void* qa, const void* qb,
                                   const int* ga, const int* gb,
                                   const unsigned char* si,
                                   const unsigned char* sj, int npairs,
                                   float* out_hi, float* out_lo, int n, int M,
                                   int N, int K, int Kp, int Np, int bk,
                                   int bkp, cudaStream_t stream) {
  if (npairs < 1 || npairs > kMaxPairs || bk < 1 || bkp % kTileK ||
      bkp < bk || Kp % 8 || Np < N || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  PairTable pairs{};
  for (int q = 0; q < npairs; ++q) {
    if (si[q] >= n || sj[q] >= n) return static_cast<int>(cudaErrorInvalidValue);
    pairs.si[q] = si[q];
    pairs.sj[q] = sj[q];
  }
  const int nkb = (K + bk - 1) / bk;
  if (K < 1 || (nkb - 1) * bkp + std::min(bk, K - (nkb - 1) * bk) > Kp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{ga, gb, out_hi, out_lo, n, M, N, K, bk, bkp, nkb, npairs};
  return launch<Shipped>(qa, qb, n, Kp, Np, pairs, args, stream);
}
