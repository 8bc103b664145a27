// The forward NeRF-W field on Hopper (sm_90a) for the two serving kernels,
// K2 (march.cu) and K5 (merged.cu), on a tile of 128 (ray, sample) rows;
// for the per-sample field K1 (mlp_fwd.cu) on a tile of 128 independent
// rows (Kind ROW_TILE); and under field_bwd_sm90.cuh's backward tile.  The
// argument record, its parsing, the composite and the error strings come
// from field.cuh.
//
// Numerics are field.cuh's: encodings y = 2^i o + z (2^i d) and activations
// held in bf16, every product accumulated in f32 on the tensor cores, bias +
// relu in f32 rounded to bf16, the density head an f32 multiply-and-sum over
// the bf16 trunk output, happ = (relu(hdir_pre) + emb@Wapp) + bapp in f32
// before the bf16 rgb product.  Only the summation order differs.
//
// Design.  A persistent CTA per SM walks over tiles with 3 warpgroups.
// - Warpgroup 2 produces (setmaxnreg leaves it 96 registers a thread and
//   gives the consumers 200, where 12 warps otherwise get 168).
//   Its first thread streams the weights through a ring of NST shared
//   memory stages.  A stage is one 64-deep K slice of one layer's whole
//   output (256 x 64 bf16 = 32 KB; 128 x 64 for the dir layer), filled by
//   one TMA tensor load that writes the 128-byte-swizzled K-major form
//   wgmma reads (zeros past the matrix's K).  full/empty mbarriers pace it.
//   The tensor maps are encoded on the host per launch
//   (cuTensorMapEncodeTiled through the runtime's driver entry point, so
//   the build links no driver library).
//   Its warps 1-3, the encoders, load each tile's rays and encode them into
//   one of two encoding buffers while the consumers run the tile before, and
//   form the per-ray appearance term emb @ Wapp^T (enc_full/enc_empty and
//   app_full/app_empty mbarriers).  So the encode, ~sin evaluations of 96
//   columns a row, leaves the tensor cores' critical path.
//   K1's rows each have their own embedding: the encoders read each row's
//   point, direction and time from device memory and stash the rows' bf16
//   embeddings in a device scratch before they publish the buffer; the
//   producer loads Wapp and those embeddings into one more ring stage after
//   the dir layer's, and emb @ Wapp^T is one wgmma (m64n128, K = E) into the
//   accumulators the dir layer's m64n128 leaves free (app_rows_mma, also
//   K8's).
// - Warps 0-7 are two consumer warpgroups; warpgroup g owns rows 64g..64g+63
//   and each layer's whole N: wgmma.mma_async m64n256k16 (m64n128k16 for
//   the dir layer), A = its rows of the activations in shared memory, B =
//   the stage, 128 f32 accumulators a thread.  A warpgroup reads only its
//   own rows of A, so after wgmma.wait_group 0 it writes the layer's output
//   back into the same activation buffer (stmatrix): one 64 KB buffer, not
//   two.  The density and rgb heads are reduced from the accumulators in
//   registers (a quad of lanes holds a row).  Then both warpgroups join and
//   the kernel composites (K1: writes the rows' rgb and sigma).
//   Generic stores that wgmma reads (encode, epilogues) are followed by
//   fence.proxy.async before the barrier that publishes them.
// Shared memory: ring 96 KB (three stages), activations 64 KB (128 rows x
// 256 as four 64-column blocks), two encoding buffers of 29 KB (encx 16 KB
// + a 4 KB tail for kx = 80 (time), encd 8 KB, the rows' depths, the rays'
// origins, directions and times), the appearance term 4 KB (K1: its tile's
// points, directions and times), rgb and sigma 2 KB: 230,400 of the 232,448 bytes a block may use.  K5's
// merge arrays live in the activation buffer between tiles.
//
// Swizzled layouts (an A segment of w <= 64 columns, a K slice): row r of a
// segment with pitch p = 32, 64 or 128 bytes (w = 16, 32, 48..64) sits at
// r * p, its 16-byte chunk c at c ^ (r & 7), c ^ ((r >> 1) & 3) or
// c ^ ((r >> 2) & 1): CUTLASS's Swizzle<3|2|1, 4, 3> on addresses whose
// base is aligned to the pattern (1024 bytes here), the layouts the wgmma
// descriptor's swizzle modes 1, 2 and 3 name; a k16 step is 32 bytes on.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver call goes through the runtime
#include <cstddef>

#include "field.cuh"

namespace danerf {
namespace sm90 {

constexpr int ROWS = TILE_M;                // 128 rows a tile
constexpr int CONSUMERS = 256;              // two consumer warpgroups
constexpr int ENCODERS = 96;                // warps 1-3 of the producer warpgroup
constexpr int ENC0 = CONSUMERS + 32;        // the first encoder thread
constexpr int THREADS90 = CONSUMERS + 128;  // + the producer warpgroup
constexpr int NST = 3;                      // ring stages
constexpr int KS = 64;                      // K slice of a stage
constexpr int STAGE_BYTES = HID * KS * 2;   // 32 KB
constexpr int BLK = ROWS * 128;             // one 64-column SW128 block of the tile, 16 KB
constexpr int ACC = HID / 2;                // f32 accumulators a thread (m64n256)

// What a tile's rows are: rays of s samples (K2-K7), 128 independent rows
// (K1, K8), K9's two row sets of one tile's rays (coarse, fine).
enum Kind { RAYS = 0, ROW_TILE = 1, HIER = 2 };

// One tile's encoder output.
struct __align__(1024) EncBuf {
  unsigned char encx[BLK + ROWS * 32];      // columns 0..63, then a 16-column tail (kx = 80)
  unsigned char encd[ROWS * 64];            // kd <= 32
  float z[ROWS];                            // each row's depth
  float o[MAX_RPC * 3], d[MAX_RPC * 3];
  float t[MAX_RPC];                         // per-ray time (0 without time)
};

struct __align__(1024) Smem90 {
  unsigned char ring[NST][STAGE_BYTES];     // first: the producer addresses it from the base
  unsigned char act[4 * BLK];               // trunk activations; K5's merge arrays between tiles
  EncBuf enc[2];                            // tile c in enc[c & 1]
  float app[MAX_RPC * HALF];                // per-ray emb@Wapp (f32); K1: its tile's x, d, t
  float rgb[ROWS * 3];
  float sigma[ROWS];
  unsigned long long full[NST], empty[NST];
  unsigned long long enc_full[2], enc_empty[2], app_full, app_empty;
};
// Dynamic shared memory: the struct, which starts the block's dynamic
// shared memory (1024-aligned on sm_90, behind the 1 KB the system
// reserves; init_ring checks it).
constexpr size_t SMEM_BYTES = sizeof(Smem90);
static_assert(SMEM_BYTES <= 232448, "the tile exceeds the 227 KB a block may use");

// One weight tensor map per trunk layer and one for the dir layer.
struct __align__(64) WeightMaps {
  CUtensorMap m[MAX_LAYERS + 1];
};

// The rays of a launch: per-ray inputs, and the depths of each ray's s rows
// (K2: its samples; K5: its fine samples).  K5's encoders also prefetch the
// tile's coarse depths and field (pre_z, pre_f; null for K2) into L2 for
// its merge.  K1: R rows, o their points, s = 1, rpc = ROWS, no z.
struct Rays {
  const float* o;
  const float* d;
  const float* emb;
  const float* t;
  const float* z;
  const float* pre_z;
  const float* pre_f;
  long long R, n_tiles;
  int s, rpc, pre_n;  // pre_n: coarse samples a ray
};

// K1's per-row appearance term: the tensor maps of Wapp (HALF x E, boxes of
// 64 K x HALF) and of the stash of the rows' bf16 embeddings (rows x E,
// boxes of 64 x 128), each zero past E, and the stash.  Null for K2, K5.
struct RowApp {
  const CUtensorMap* wapp;
  const CUtensorMap* embr;
  __nv_bfloat16* stash;
};

// K of trunk layer i (i == num_layers: the dir layer): layer 0 reads enc_x,
// a skip layer [h, enc_x], the rest h; the dir layer [h, enc_d].
__host__ __device__ inline int layer_k(const FieldArgs& P, int i) {
  if (i == P.num_layers) return HID + P.kd;
  if (i == 0) return P.kx;
  return ((P.skip_mask >> i) & 1) ? HID + P.kx : HID;
}

// Row pitch in bytes of an A segment of w columns (a multiple of 16, <= 64).
__host__ __device__ inline int seg_pitch(int w) { return w <= 16 ? 32 : (w <= 32 ? 64 : 128); }

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, col) in a segment of row pitch `pitch`.
__device__ __forceinline__ uint32_t swz(int row, int col, int pitch) {
  const int x = pitch == 128 ? (row & 7) : (pitch == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1));
  return row * pitch + ((((col >> 3) ^ x)) << 4) + (col & 7) * 2;
}

// wgmma shared-memory descriptor of a K-major swizzled operand at `addr`
// (shared window): start >> 4, leading offset 1 (unused when swizzled),
// stride between 8-row groups 8 * pitch, swizzle mode 1/2/3 for 128/64/32.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int pitch) {
  const uint64_t mode = pitch == 128 ? 1 : (pitch == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * pitch) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// The barrier at shared address `b` expects `bytes` more of the transaction.
__device__ __forceinline__ void mbar_expect_tx(uint32_t b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// Wait for the completion of the phase of parity `parity` of the barrier at
// shared address `a`.  A lost arrival traps after ~10 s instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait_at(uint32_t a, int parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b, int parity) {
  mbar_wait_at(smem_u32(b), parity);
}

// The box at (c0, c1) of `map` into shared memory at dst, its bytes counted
// on the barrier at bar.
__device__ __forceinline__ void tma_load_at(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bf16x2 of (lo, hi): lo in the low half (the lower column).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// Generic-proxy writes to device memory before a TMA load reads them.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Named barriers: 1 the two consumer warpgroups, 2 + g warpgroup g, 4 the
// encoders.
__device__ __forceinline__ void consumers_sync() { bar_sync(1, CONSUMERS); }
__device__ __forceinline__ void wg_sync(int g) { bar_sync(2 + g, 128); }
__device__ __forceinline__ void encoders_sync() { bar_sync(4, ENCODERS); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators after a wait: no read of them moves above it.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DANERF_ACC8(b)                                                                   \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),        \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 256 f32 of the warpgroup) (+)= A (64 x 16) B^T (256 x 16), both bf16
// K-major in shared memory; scale_d = 0 overwrites.
__device__ __forceinline__ void wgmma_n256(float (&d)[ACC], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : DANERF_ACC8(0), DANERF_ACC8(8), DANERF_ACC8(16), DANERF_ACC8(24), DANERF_ACC8(32),
        DANERF_ACC8(40), DANERF_ACC8(48), DANERF_ACC8(56), DANERF_ACC8(64), DANERF_ACC8(72),
        DANERF_ACC8(80), DANERF_ACC8(88), DANERF_ACC8(96), DANERF_ACC8(104), DANERF_ACC8(112),
        DANERF_ACC8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The dir layer's N = 128 into d[0..63].
__device__ __forceinline__ void wgmma_n128(float (&d)[ACC], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : DANERF_ACC8(0), DANERF_ACC8(8), DANERF_ACC8(16), DANERF_ACC8(24), DANERF_ACC8(32),
        DANERF_ACC8(40), DANERF_ACC8(48), DANERF_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64..127] (+)= A (64 x 16) B^T (128 x 16), both K-major: the per-row
// appearance term (K1, K8) beside the dir layer's accumulator in d[0..63].
__device__ __forceinline__ void wgmma_n128_hi(float (&d)[ACC], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : DANERF_ACC8(64), DANERF_ACC8(72), DANERF_ACC8(80), DANERF_ACC8(88), DANERF_ACC8(96),
        DANERF_ACC8(104), DANERF_ACC8(112), DANERF_ACC8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef DANERF_ACC8

// ------------------------------------------------------------------ setup

__device__ __forceinline__ Smem90& smem90() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return *reinterpret_cast<Smem90*>(smem_raw);
}

// Barriers: full[s] completes when the producer's load lands, empty[s] when
// both consumer warpgroups are done with the stage; enc_full[b] when the
// encoders have filled buffer b, enc_empty[b] when the consumers are done
// with it; app_full when the encoders have formed a tile's appearance term,
// app_empty when both consumer warpgroups have read it.
__device__ __forceinline__ void init_ring(Smem90& sm) {
  if (threadIdx.x == 0) {
    if (smem_u32(&sm) & 1023) __trap();  // the swizzle patterns need 1024-byte alignment
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.enc_full[b], 1);
      mbar_init(&sm.enc_empty[b], 1);
    }
    mbar_init(&sm.app_full, 1);
    mbar_init(&sm.app_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The roles: the kernel calls produce() and returns on the producer
// warpgroup, consumer_regs() then the consumers' work on the others, so the
// two paths never reconverge (setmaxnreg needs that).
__device__ __forceinline__ bool is_producer() { return threadIdx.x >= CONSUMERS; }

// The consumers take the registers the producer warpgroup gives up: 128 x
// 96 + 256 x 200 <= 384 x 168, the launch's allocation.
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
}

__device__ __forceinline__ int my_tiles(long long n_tiles) {
  return (int)((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
}

// The position in the ring: the stage and the parity of its current use.
struct Pipe {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The weight stream (the first thread of the producer warpgroup): every
// tile of this CTA streams every layer's K slices, in the order the
// consumers take them.  K1 (ROW_TILE): then, once the encoders have stashed
// the tile's embeddings, one more stage: Wapp (16 KB) and the tile's 128
// bf16 embeddings (16 KB), each zero past E.
template <int KIND>
__device__ __forceinline__ void stream_weights(const WeightMaps& maps, const FieldArgs& P,
                                               long long n_tiles, const RowApp& ra) {
  Smem90& sm = smem90();
  const uint32_t ring = smem_u32(&sm);
  const uint32_t full = ring + offsetof(Smem90, full), empty = ring + offsetof(Smem90, empty);
  const int tiles = my_tiles(n_tiles);
  Pipe pp;
  for (int c = 0; c < tiles; ++c) {
    for (int i = 0; i <= P.num_layers; ++i) {
      const int K = layer_k(P, i);
      const uint32_t bytes = (i == P.num_layers ? HALF : HID) * KS * 2;
      for (int k0 = 0; k0 < K; k0 += KS) {
        mbar_wait_at(empty + 8 * pp.stage, pp.phase ^ 1);
        mbar_expect_tx(full + 8 * pp.stage, bytes);
        tma_load_at(ring + pp.stage * STAGE_BYTES, &maps.m[i], k0, 0, full + 8 * pp.stage);
        pp.advance();
      }
    }
    if constexpr (KIND == ROW_TILE) {
      const int row0 = (int)((blockIdx.x + (long long)c * gridDim.x) * ROWS);
      mbar_wait(&sm.enc_full[c & 1], (c >> 1) & 1);  // the tile's embeddings are in the stash
      mbar_wait_at(empty + 8 * pp.stage, pp.phase ^ 1);
      mbar_expect_tx(full + 8 * pp.stage, 2 * HALF * KS * 2);
      tma_load_at(ring + pp.stage * STAGE_BYTES, ra.wapp, 0, 0, full + 8 * pp.stage);
      tma_load_at(ring + pp.stage * STAGE_BYTES + HALF * KS * 2, ra.embr, 0, row0,
                  full + 8 * pp.stage);
      pp.advance();
    }
  }
}

// Column pitches of a tile's encoding buffer: encx's first block and its
// tail (kx = 80), encd.
struct EncPitch {
  int x0, x1, d;
};

__device__ __forceinline__ void put_x(EncBuf& eb, const EncPitch& pt, int row, int col, float v) {
  unsigned char* p = col < KS ? eb.encx + swz(row, col, pt.x0)
                              : eb.encx + BLK + swz(row, col - KS, pt.x1);
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void put_d(EncBuf& eb, const EncPitch& pt, int row, int col, float v) {
  *reinterpret_cast<__nv_bfloat16*>(eb.encd + swz(row, col, pt.d)) = __float2bfloat16_rn(v);
}

// Encode one group of one row into buffer eb (the JAX _encode's values,
// in its column order): group l < Lp is position level l, the columns
// 3 + 6l.. of sin(y) and sin(y + pi/2) for y = 2^l o + z (2^l d) of each
// dimension (level 0 also the columns 0..2, y itself); group Lp + l is
// direction level l (y = 2^l d); the last group the time's columns, t and
// sin / cos of 2^l t, then the zero padding of both encodings.  The row's
// origin o and direction d (3 floats each), depth *z (null: 0, the rows of
// K1 and K8, whose y = 2^l x) and time *t are read where the caller points;
// an invalid row is 0.  Six independent sin evaluations an item keep the
// encoders' latency hidden.
__device__ __forceinline__ void encode_group_at(const FieldArgs& P, EncBuf& eb, const EncPitch& pt,
                                                int row, int grp, bool valid, const float* o,
                                                const float* d, const float* zp, const float* tp) {
  const float half_pi = 1.57079637f;
  const int Lp = P.pos_levels, Ld = P.dir_levels;
  if (grp < Lp + Ld) {
    const bool is_dir = grp >= Lp;
    const int lvl = is_dir ? grp - Lp : grp;
    const float f = (float)(1 << lvl);
    const float z = (is_dir || zp == nullptr) ? 0.f : *zp;
    const float* src = is_dir ? d : o;
    const float* dir = d;
    float y[3], sn[3], cs[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = src[k] * f;
      const float b = (is_dir ? 0.f : dir[k]) * f;
      y[k] = __fadd_rn(a, __fmul_rn(z, b));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sn[k] = valid ? sinf(y[k]) : 0.f;
      cs[k] = valid ? sinf(__fadd_rn(y[k], half_pi)) : 0.f;
      if (!valid) y[k] = 0.f;
    }
    const int c0 = 3 + 6 * lvl;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (is_dir) {
        put_d(eb, pt, row, c0 + k, sn[k]);
        put_d(eb, pt, row, c0 + 3 + k, cs[k]);
        if (lvl == 0) put_d(eb, pt, row, k, y[k]);
      } else {
        put_x(eb, pt, row, c0 + k, sn[k]);
        put_x(eb, pt, row, c0 + 3 + k, cs[k]);
        if (lvl == 0) put_x(eb, pt, row, k, y[k]);
      }
    }
    return;
  }
  const int nx = 3 * (1 + 2 * Lp), nd = 3 * (1 + 2 * Ld);
  if (P.nt > 0) {
    const float t = valid ? *tp : 0.f;
    put_x(eb, pt, row, nx, t);
    for (int l = 0; l < P.time_levels; ++l) {
      const float y = t * (float)(1 << l);
      put_x(eb, pt, row, nx + 1 + 2 * l, valid ? sinf(y) : 0.f);
      put_x(eb, pt, row, nx + 2 + 2 * l, valid ? sinf(__fadd_rn(y, half_pi)) : 0.f);
    }
  }
  for (int c = nx + P.nt; c < P.kx; ++c) put_x(eb, pt, row, c, 0.f);
  for (int c = nd; c < P.kd; ++c) put_d(eb, pt, row, c, 0.f);
}

// encode_group_at for row `row` of a tile of rays, ray j = row / s of the
// buffer's rays; a row past the tile's rays (j >= rpc) is 0.
__device__ __forceinline__ void encode_group(const FieldArgs& P, EncBuf& eb, const EncPitch& pt,
                                             int row, int grp, int j, int rpc) {
  const int jj = j < rpc ? j : 0;
  encode_group_at(P, eb, pt, row, grp, j < rpc, eb.o + jj * 3, eb.d + jj * 3, eb.z + row,
                  eb.t + jj);
}

// The encoders (96 threads): for each tile c of this CTA, once the
// consumers are done with buffer c & 1, load the tile's rays (zeros past R)
// and each row's depth (row = ray j * s + sample; zeros past the tile's
// rays), encode every row into the buffer (encode_group) and publish it;
// prefetch K5's coarse inputs of the tile into L2; then, once the consumers
// have read the previous tile's appearance term, form this one's.
__device__ __forceinline__ void encode_tiles(const FieldArgs& P, const Rays& rays) {
  Smem90& sm = smem90();
  const int et = threadIdx.x - ENC0;
  const int s = rays.s, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const float inv_s = 1.f / (float)s;
  const EncPitch pt{seg_pitch(min(P.kx, KS)), seg_pitch(P.kx - KS), seg_pitch(P.kd)};
  const int items = ROWS * (P.pos_levels + P.dir_levels + 1);
  const __nv_bfloat16* wapp = P.mats + P.wapp_off;
  for (int c = 0; c < tiles; ++c) {
    const long long ray0 = (blockIdx.x + (long long)c * gridDim.x) * rpc;
    EncBuf& eb = sm.enc[c & 1];
    mbar_wait(&sm.enc_empty[c & 1], ((c >> 1) & 1) ^ 1);
    for (int idx = et; idx < rpc * 3; idx += ENCODERS) {
      const long long r = ray0 + idx / 3;
      eb.o[idx] = r < rays.R ? rays.o[r * 3 + idx % 3] : 0.f;
      eb.d[idx] = r < rays.R ? rays.d[r * 3 + idx % 3] : 0.f;
    }
    for (int j = et; j < rpc; j += ENCODERS)
      eb.t[j] = (rays.t != nullptr && ray0 + j < rays.R) ? rays.t[ray0 + j] : 0.f;
    for (int row = et; row < ROWS; row += ENCODERS) {
      const int j = row / s;
      const long long r = ray0 + j;
      eb.z[row] = (j < rpc && r < rays.R) ? rays.z[r * s + (row - j * s)] : 0.f;
    }
    encoders_sync();
    // item = group * 128 + row: a warp's lanes take one group of 32 rows
    for (int it = et; it < items; it += ENCODERS) {
      const int row = it & (ROWS - 1);
      const int j = __float2int_rz(((float)row + 0.5f) * inv_s);  // row / s, exactly
      encode_group(P, eb, pt, row, it >> 7, j, rpc);
    }
    fence_proxy_async();
    encoders_sync();
    if (et == 0) mbar_arrive(&sm.enc_full[c & 1]);
    if (rays.pre_f != nullptr) {
      // K5's merge reads the tile's coarse depths and field: start them on
      // their way from HBM to L2
      const long long r1 = min(ray0 + rpc, rays.R);
      const char* f0 = reinterpret_cast<const char*>(rays.pre_f + ray0 * 4 * rays.pre_n);
      const char* z0 = reinterpret_cast<const char*>(rays.pre_z + ray0 * rays.pre_n);
      const long long fb = (r1 - ray0) * 4 * rays.pre_n * 4, zb = (r1 - ray0) * rays.pre_n * 4;
      for (long long off = 128LL * et; off < fb; off += 128LL * ENCODERS)
        asm volatile("prefetch.L2 [%0];\n" ::"l"(f0 + off));
      for (long long off = 128LL * et; off < zb; off += 128LL * ENCODERS)
        asm volatile("prefetch.L2 [%0];\n" ::"l"(z0 + off));
    }
    mbar_wait(&sm.app_empty, (c & 1) ^ 1);
    for (int idx = et; idx < rpc * HALF; idx += ENCODERS) {
      const int j = idx / HALF, n = idx - j * HALF;
      const long long r = ray0 + j;
      float acc = 0.f;
      if (r < rays.R)
        for (int k = 0; k < P.emb_dim; ++k)
          acc += bf16_round(rays.emb[r * P.emb_dim + k]) *
                 __bfloat162float(wapp[n * P.emb_dim + k]);
      sm.app[idx] = acc;
    }
    encoders_sync();
    if (et == 0) mbar_arrive(&sm.app_full);
  }
}

// K1's encoders (96 threads): for each tile c of this CTA, once the
// consumers are done with buffer c & 1, load the tile's 128 points,
// directions and times (zeros past R) into sm.app, which K1's appearance
// term does not use, encode every row from there (y = 2^i x, the rays'
// form at z = 0), stash the rows' bf16 embeddings (zeros past R; 8 a
// thread, E % 16 == 0 and emb 16-byte aligned) for the producer's TMA, and
// publish the buffer.
__device__ __forceinline__ void encode_row_tiles(const FieldArgs& P, const Rays& rows,
                                                 __nv_bfloat16* __restrict__ stash) {
  static_assert(7 * ROWS <= MAX_RPC * HALF, "the row tile's inputs must fit in sm.app");
  Smem90& sm = smem90();
  float* xs = sm.app;         // 128 x 3
  float* ds = xs + 3 * ROWS;  // 128 x 3
  float* ts = ds + 3 * ROWS;  // 128
  const int et = threadIdx.x - ENC0;
  const int tiles = my_tiles(rows.n_tiles), q8 = P.emb_dim / 8;
  const EncPitch pt{seg_pitch(min(P.kx, KS)), seg_pitch(P.kx - KS), seg_pitch(P.kd)};
  const int items = ROWS * (P.pos_levels + P.dir_levels + 1);
  for (int c = 0; c < tiles; ++c) {
    const long long row0 = (blockIdx.x + (long long)c * gridDim.x) * ROWS;
    EncBuf& eb = sm.enc[c & 1];
    mbar_wait(&sm.enc_empty[c & 1], ((c >> 1) & 1) ^ 1);
    for (int i = et; i < 3 * ROWS; i += ENCODERS) {
      const bool ok = row0 + i / 3 < rows.R;
      xs[i] = ok ? rows.o[row0 * 3 + i] : 0.f;
      ds[i] = ok ? rows.d[row0 * 3 + i] : 0.f;
    }
    for (int i = et; i < ROWS; i += ENCODERS)
      ts[i] = (rows.t != nullptr && row0 + i < rows.R) ? rows.t[row0 + i] : 0.f;
    encoders_sync();
    // item = group * 128 + row: a warp's lanes take one group of 32 rows
    for (int it = et; it < items; it += ENCODERS) {
      const int row = it & (ROWS - 1);
      encode_group_at(P, eb, pt, row, it >> 7, row0 + row < rows.R, xs + row * 3, ds + row * 3,
                      nullptr, ts + row);
    }
    fence_proxy_async();
    for (int q = et; q < ROWS * q8; q += ENCODERS) {
      const long long at = row0 * q8 * 8 + 8LL * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + q / q8 < rows.R) {
        const float4 a = *reinterpret_cast<const float4*>(rows.emb + at);
        const float4 b = *reinterpret_cast<const float4*>(rows.emb + at + 4);
        v = make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y), bf16x2(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(stash + at) = v;
    }
    fence_proxy_async_global();  // the producer's TMA reads the stash next
    encoders_sync();             // also: every encoder is done with xs, ds, ts
    if (et == 0) mbar_arrive(&sm.enc_full[c & 1]);
  }
}

// The producer warpgroup: gives registers up, then its first thread
// streams the weights and its warps 1-3 encode; the rest of warp 0 is done.
// K1 (ROW_TILE) takes ra, its per-row appearance inputs.
template <int KIND = RAYS>
__device__ __forceinline__ void produce(const WeightMaps& maps, const FieldArgs& P,
                                        const Rays& rays, const RowApp& ra = RowApp{}) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
  if (threadIdx.x >= ENC0) {
    if constexpr (KIND == ROW_TILE)
      encode_row_tiles(P, rays, ra.stash);
    else
      encode_tiles(P, rays);
  } else if (threadIdx.x == CONSUMERS) {
    stream_weights<KIND>(maps, P, rays.n_tiles, ra);
  }
}

// ------------------------------------------------------------- tile stages

// An A segment: shared address, row pitch, width in columns.
struct Seg {
  uint32_t addr;
  int pitch, kw;
};

__device__ __forceinline__ Seg encx_seg(const EncBuf& eb, const FieldArgs& P, int b) {
  const int w = b == 0 ? min(P.kx, KS) : P.kx - KS;
  return {smem_u32(eb.encx + b * BLK), seg_pitch(w), w};
}

// The segment of slice s of layer i (i == num_layers: the dir layer).
__device__ __forceinline__ Seg a_seg(const Smem90& sm, const EncBuf& eb, const FieldArgs& P,
                                     int i, int s) {
  if (i == 0) return encx_seg(eb, P, s);
  if (s < HID / KS) return {smem_u32(sm.act + s * BLK), 128, KS};
  if (i == P.num_layers) return {smem_u32(eb.encd), seg_pitch(P.kd), P.kd};
  return encx_seg(eb, P, s - HID / KS);
}

// acc = A @ W_i^T over layer i's K slices for warpgroup g's 64 rows, each
// slice released as soon as its products are done.
template <int N>
__device__ __forceinline__ void mma_layer(float (&acc)[ACC], Smem90& sm, const EncBuf& eb,
                                          const FieldArgs& P, int i, int g, Pipe& pp) {
  const int n_slices = (layer_k(P, i) + KS - 1) / KS;
  int prev = -1;
  for (int s = 0; s < n_slices; ++s) {
    mbar_wait(&sm.full[pp.stage], pp.phase);
    __syncwarp();
    const Seg sg = a_seg(sm, eb, P, i, s);
    const uint64_t da = make_desc(sg.addr + g * 64 * sg.pitch, sg.pitch);
    const uint64_t db = make_desc(smem_u32(sm.ring[pp.stage]), 128);
    wgmma_fence();
    for (int k = 0; k < sg.kw / 16; ++k) {
      // a k16 step is 32 bytes on: 2 in the descriptor's address field
      if (N == HID)
        wgmma_n256(acc, da + 2 * k, db + 2 * k, (s | k) != 0);
      else
        wgmma_n128(acc, da + 2 * k, db + 2 * k, (s | k) != 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[prev]);
    }
    prev = pp.stage;
    pp.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[prev]);
}

// acc[64..127] = A (the tile's 128 rows' bf16 embeddings, the second half
// of the ring's current stage) @ B^T (Wapp, its first half), K = E in k16
// steps, zero past E, for warpgroup g's 64 rows: the per-row appearance
// term of K1 and K8, beside the dir layer's accumulator in acc[0..63].
// ring, full, empty: the ring's base and barriers.  Releases the stage.
__device__ __forceinline__ void app_rows_mma(float (&acc)[ACC], uint32_t ring,
                                             unsigned long long* full, unsigned long long* empty,
                                             int E, int g, Pipe& pp) {
  mbar_wait(&full[pp.stage], pp.phase);
  __syncwarp();
  const uint32_t st = ring + pp.stage * STAGE_BYTES;
  const uint64_t da = make_desc(st + HALF * KS * 2 + g * 64 * 128, 128);
  const uint64_t db = make_desc(st, 128);
  wgmma_fence();
  for (int k = 0; k < E / 16; ++k) wgmma_n128_hi(acc, da + 2 * k, db + 2 * k, k != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[pp.stage]);
  pp.advance();
}

// bf16x2 of (relu(lo), relu(hi)): lo in the low half (the lower column).
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// A trunk layer's epilogue for warpgroup g: bias + relu, rounded to bf16,
// written over the layer's input in sm.act, four 8 x 8 tiles a stmatrix
// (lane l addresses row l & 7 of tile l >> 3: rows +8 for odd tiles,
// columns +8 for the upper two); the last layer also sums each of the
// thread's rows r0, r0 + 8 of density products into dsum.
template <bool LAST>
__device__ __forceinline__ void trunk_epilogue(const float (&acc)[ACC], const float* bias,
                                               const float* wd, Smem90& sm, int g,
                                               float (&dsum)[2]) {
  const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  const int row = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t base = smem_u32(sm.act) + row * 128;
  const int hi = lane >> 4, l7 = lane & 7;
#pragma unroll
  for (int j = 0; j < HID / 8; j += 2) {
    uint32_t v[2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 8 * (j + jj) + cq;
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[jj][h] = relu_bf16x2(acc[4 * (j + jj) + 2 * h] + b.x,
                               acc[4 * (j + jj) + 2 * h + 1] + b.y);
        if constexpr (LAST) {
          const float2 w = __ldg(reinterpret_cast<const float2*>(wd + c));
          dsum[h] += __uint_as_float(v[jj][h] << 16) * w.x +
                     __uint_as_float(v[jj][h] & 0xffff0000u) * w.y;
        }
      }
    }
    const uint32_t addr = base + (j >> 3) * BLK + ((((j & 7) + hi) ^ l7) << 4);
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(v[0][0]), "r"(v[0][1]), "r"(v[1][0]), "r"(v[1][1])
                 : "memory");
  }
}

// The field on tile c (the c-th of this CTA) for the calling consumer
// warpgroup's rows, once the encoders have filled enc[c & 1]: the trunk
// layers in place in sm.act, sigma from the last one's accumulators, the
// dir layer and the rgb head from its accumulators.  Leaves sm.rgb (128 x
// 3) and sm.sigma (128) valid behind a consumers_sync.  s = samples per ray
// in the tile's rows.  The appearance term: a ray's from sm.app (RAYS, K2
// and K5), a row's from one more ring stage (ROW_TILE, K1: app_rows_mma; s,
// rpc unread).
template <int KIND = RAYS>
__device__ __forceinline__ void field_tile90(const FieldArgs& P, Smem90& sm, int c, int s,
                                             int rpc, Pipe& pp, float (&acc)[ACC]) {
  const int g = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int r0 = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int cq = 2 * (lane & 3);  // the thread's first column in each 8-column block
  const int L = P.num_layers;
  const EncBuf& eb = sm.enc[c & 1];
  mbar_wait(&sm.enc_full[c & 1], (c >> 1) & 1);
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = 0.f;

  for (int i = 0; i < L; ++i) {
    mma_layer<HID>(acc, sm, eb, P, i, g, pp);
    wg_sync(g);  // every warp's products read A before any row is overwritten
    const float* bias = P.vecs + P.b_off[i];
    float dsum[2] = {0.f, 0.f};
    if (i == L - 1) {
      trunk_epilogue<true>(acc, bias, P.vecs + P.wd_off, sm, g, dsum);
      const float bd = __ldg(P.vecs + P.bd_off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dsum[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += bd;
        if ((lane & 3) == 0)
          sm.sigma[r0 + 8 * h] = P.softplus ? fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)))
                                            : fmaxf(v, 0.f);
      }
    } else {
      trunk_epilogue<false>(acc, bias, nullptr, sm, g, dsum);
    }
    fence_proxy_async();
    wg_sync(g);
  }

  // dir branch and rgb head: happ = (relu([h, enc_d] @ Wdir^T + bdir) +
  // emb@Wapp^T) + bapp, rounded to bf16; rgb = sigmoid(happ @ Wrgb^T + brgb)
  mma_layer<HALF>(acc, sm, eb, P, L, g, pp);
  if constexpr (KIND == ROW_TILE)
    app_rows_mma(acc, smem_u32(&sm), sm.full, sm.empty, P.emb_dim, g, pp);
  else
    mbar_wait(&sm.app_full, c & 1);
  {
    const float* bdir = P.vecs + P.bdir_off;
    const float* bapp = P.vecs + P.bapp_off;
    const __nv_bfloat16* wrgb = P.mats + P.wrgb_off;
    const float* app[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      app[h] = KIND == ROW_TILE ? nullptr : sm.app + min((r0 + 8 * h) / s, rpc - 1) * HALF;
    float cs[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int c8 = 8 * j + cq;
      const float2 bd2 = __ldg(reinterpret_cast<const float2*>(bdir + c8));
      const float2 ba2 = __ldg(reinterpret_cast<const float2*>(bapp + c8));
      float2 w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[k] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(wrgb + k * HALF + c8));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = acc[4 * j + 2 * h] + bd2.x, p1 = acc[4 * j + 2 * h + 1] + bd2.y;
        const float e0 = KIND == ROW_TILE ? acc[64 + 4 * j + 2 * h] : app[h][c8];
        const float e1 = KIND == ROW_TILE ? acc[64 + 4 * j + 2 * h + 1] : app[h][c8 + 1];
        const float h0 = bf16_round((fmaxf(p0, 0.f) + e0) + ba2.x);
        const float h1 = bf16_round((fmaxf(p1, 0.f) + e1) + ba2.y);
#pragma unroll
        for (int k = 0; k < 3; ++k) cs[h][k] += h0 * w[k].x + h1 * w[k].y;
      }
    }
    if constexpr (KIND != ROW_TILE) {
      wg_sync(g);  // the warpgroup is done with sm.app
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.app_empty);
    }
    const float* brgb = P.vecs + P.brgb_off;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = cs[h][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0)
          sm.rgb[(r0 + 8 * h) * 3 + k] = 1.f / (1.f + expf(-(v + __ldg(brgb + k))));
      }
  }
  consumers_sync();
}

// The end of tile c for the consumers: once every consumer is done with
// the tile's buffer (its depths), sm.rgb, sm.sigma and sm.act, hand the
// buffer back to the encoders.
__device__ __forceinline__ void end_tile(Smem90& sm, int c) {
  consumers_sync();
  if (threadIdx.x == 0) mbar_arrive(&sm.enc_empty[c & 1]);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a (rows, K) row-major bf16 matrix, read in boxes of
// 64 K x rows, 128-byte swizzle, zeros past K.
inline int weight_map(EncodeTiledFn enc, CUtensorMap* m, const __nv_bfloat16* w, int K, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KS, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(w), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tensor map of a (rows, cols) row-major bf16 matrix at p, boxes of
// box_c x box_r, 128-byte swizzle.
inline int map2d(EncodeTiledFn enc, CUtensorMap* m, const void* p, long long cols,
                 long long rows, int box_c, int box_r) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Host set-up shared by K1, K2 and K5: the weight maps, the kernel's shared
// memory limit and the persistent grid (one CTA per SM, at most one a tile).
template <class Kernel>
inline int launch_setup(Kernel kernel, const FieldArgs& P, long long n_tiles, WeightMaps* maps,
                        unsigned* grid) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  for (int i = 0; i < P.num_layers; ++i) {
    const int err = weight_map(enc, &maps->m[i], P.mats + P.w_off[i], layer_k(P, i), HID);
    if (err) return err;
  }
  const int err = weight_map(enc, &maps->m[P.num_layers], P.mats + P.wdir_off,
                             layer_k(P, P.num_layers), HALF);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  *grid = (unsigned)(n_tiles < n_sm ? n_tiles : n_sm);
  return 0;
}

}  // namespace sm90
}  // namespace danerf

// The dynamic shared memory a CTA of K1, K2 or K5 takes (ptxas -v reports
// only static shared memory).
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::sm90::SMEM_BYTES; }
