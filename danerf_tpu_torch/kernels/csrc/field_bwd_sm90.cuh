// The backward of the NeRF-W field on Hopper (sm_90a) for the six training
// kernels: K3 (march_bwd.cu) and K7 (march_train.cu), the ray march's
// backward under the caller's cotangents or the MSE; K4 (merged_train.cu)
// and K6 (merged_bwd.cu), the merged fine pass's under the MSE or the
// caller's cotangents; K8 (mlp_bwd.cu), the per-sample field's under the
// caller's per-row cotangents; K9 (hier_onepass.cu), the whole 64+64 step.
// The forward with its residuals, the composite's transpose, the
// transposed chain and the dW pass, built around field_sm90.cuh's tile; the
// tile kernel is a template over the composite (MarchComp<MSE>,
// MergedComp<MSE>, RowComp), and K9's kernel runs the same phases in its
// own order.
//
// Numerics are danerf_tpu's _field_bwd_from_res: both operands of every
// product rounded to bf16 and accumulated in f32, d_pre_rgb and the
// density head in f32, the bias gradients sums of the f32 d_pre; only the
// summation order differs.  Every sum runs in a fixed order, so two calls
// give bit-identical results.
//
// Tile kernel (one persistent CTA per SM, 3 warpgroups, as field_sm90.cuh).
// - Forward: field_sm90.cuh's tile.  Each trunk layer's epilogue also keeps
//   the thread's relu gates as a bit mask (4 x 32 bits: its two rows x its
//   64 columns, the same accumulator fragment the chain's products give the
//   same thread), written to a per-CTA area of the scratch and read back by
//   that thread in the chain; the layer's output is TMA-stored from the
//   swizzled activation buffer to the stash (h).  happ goes to the stash from
//   the registers, the dir layer's gates (2 x 32 bits) to the gate area.
// - Composite: one warp per ray (field_bwd.cuh composite_keep /
//   composite_bwd; K4 and K6 merge by rank and un-permute by the kept
//   ranks; K8 takes the caller's cotangents of each row).
//   Its arrays live in the weight ring, which the producer leaves empty
//   until the consumers arrive on comp_done.
// - Chain head (CUDA cores): d_pre_rgb, d_sigma_pre, the density head's row
//   sums from the last trunk output still in the activation buffer; then
//   d_happ and d_hdir_pre on the dir layer's fragments, bf16(d_hdir_pre)
//   written into the activation buffer as the A operand of the first
//   transposed product, bf16(d_happ) beside it for the per-ray demb sums.
// - Transposed chain: d_in = bf16(d_pre) @ W[:, :HID] on wgmma m64n256k16,
//   B = the transposed blocks (kernels/fused_mlp.py transposed_mats)
//   streamed through the same ring, A = the activation buffer, the result
//   written back in place (a warpgroup reads only its own rows), gated by
//   the kept masks, TMA-stored to the stash as bf16.  Bias sums: a
//   reduce-scatter over the 8 lanes of a column (colsum8), then the warpgroup's 4
//   warps in order; each warpgroup writes its own slot of the tile's row
//   sums (2 slots a tile), summed in a fixed order by reduce_slots.
// The encoders (the producer warpgroup's warps 1-3) fill one encoding
// buffer, which the consumers hand back after the composite, so the next
// tile is encoded while this one runs its chain; they also write the
// encodings and each row's bf16 embedding to the stash.
// - K8's tile holds 128 independent rows: the appearance term is a wgmma
//   per row from one more ring stage, and so is demb (mlp_bwd.cu).
// Shared memory: ring 96 KB, activations 64 KB, one encoding buffer 29 KB,
// the appearance term, rgb, sigma, sigma_pre, field_bwd.cuh's BwdSmem, the
// column sums and K9's HierSmem: 225,280 of 232,448 bytes.
//
// dW pass: one CTA owns 128 output rows (two consumer warpgroups of m64) x
// 256 input columns of one layer's dW over one fixed row partition.  A
// producer thread streams 64-row slabs of d_pre (2 boxes of 64 columns) and
// of the layer's input (4 boxes) through a 4-stage ring; both operands are
// row-major in the stash with the row as the reduction index, so wgmma
// reads both transposed (MN-major, 128-byte swizzle).  Each slab of h is
// read twice (once per 128-row half of the output), each of d_pre once.
// The partitions are summed in order (dw90_reduce).  The jobs of 256 input
// columns take it (the trunk layers 1.. and the dir layer's hidden block);
// the narrow ones (encx of layer 0 and the skips, encd, the appearance
// projection, the rgb head) stay on field_bwd.cuh's dw_kernel, over
// NARROW_PARTS partitions.

#pragma once

#include "field_sm90.cuh"
#include "field_bwd.cuh"
#include "bwd_tiles.cuh"

namespace danerf {
namespace sm90 {

constexpr int MAX_CTAS = 160;        // persistent grid cap (the per-CTA gate areas)
constexpr int GATE_BYTES = 16 * CONSUMERS;  // one layer's gate masks of a CTA
constexpr int DW90_ROWS = 128;       // output rows of a dW CTA
constexpr int DW90_STAGES = 4;
constexpr int DW90_A = DW90_ROWS * 64 * 2;  // a slab of d_pre: 64 rows x 128 columns
constexpr int DW90_B = HID * 64 * 2;        // a slab of the input: 64 rows x 256 columns
constexpr int DW90_THREADS = CONSUMERS + 32;
constexpr int DW90_PARTS = 16;       // most row partitions of the dW pass
// Row partitions of the narrow jobs on dw_kernel: each block walks its
// partition's slabs one after the other, so its time is that walk's
// latency; 64 partitions keep it short and the blocks in one wave.
constexpr int NARROW_PARTS = 64;

// K9's arrays that outlive a tile's weight stream (rpc rays of Sc coarse
// samples, rpc Sc <= 128): the coarse field [r, g, b, sigma] and sigma_pre,
// the coarse field's cotangent from the merged composite, each ray's alpha /
// T / w of the coarse composite.
struct HierSmem {
  float kf[4 * ROWS];   // rpc x 4 x Sc
  float ksp[ROWS];      // rpc x Sc
  float gfc[4 * ROWS];  // rpc x 4 x Sc
  float scr[3 * ROWS];  // rpc x 3 x Sc
};

struct __align__(1024) SmemBwd {
  unsigned char ring[NST][STAGE_BYTES];  // the composite's arrays between forward and chain
  unsigned char act[4 * BLK];            // activations, then bf16 d_pre in place
  EncBuf enc;
  float app[MAX_RPC * HALF];
  float rgb[ROWS * 3];
  float sigma[ROWS];
  float sigma_pre[ROWS];
  float colsum[2][4][HID];               // per warpgroup, per warp: column sums
  BwdSmem bs;
  HierSmem hier;
  unsigned long long full[NST], empty[NST];
  unsigned long long enc_full, enc_empty, app_full, app_empty, comp_done, zf_ready;
};
constexpr size_t BWD_SMEM_BYTES = sizeof(SmemBwd);
static_assert(BWD_SMEM_BYTES <= 232448, "the backward tile exceeds the 227 KB a block may use");
// field_bwd.cuh's composite scratch, and the merge arrays, of every shape
// the march (K3, K7) and merged (K4, K6) kernels take (bwd_smem_bytes /
// merged_smem_bytes <= 232,448 beside field.cuh's SHAPE_TILE_BYTES) fit in
// the ring.
static_assert(232448 - SHAPE_TILE_BYTES - sizeof(BwdSmem) <= sizeof(SmemBwd::ring),
              "the composite's arrays must fit in the ring");

struct __align__(1024) SmemDw {
  unsigned char a[DW90_STAGES][DW90_A];
  unsigned char b[DW90_STAGES][DW90_B];
  unsigned long long full[DW90_STAGES], empty[DW90_STAGES];
};
constexpr size_t DW90_SMEM_BYTES = sizeof(SmemDw);

// Tensor maps of the tile kernel: the forward weights (w, as field_sm90.cuh's
// WeightMaps), the transposed trunk blocks of layers 1.. as one (L - 1) HID
// x HID matrix and the dir layer's (HID x HALF), boxes of 64 K x 256; the
// stash of h and d_pre, (L rows_s) x HID, boxes of 64 x 64 (also the dW
// pass's operands, with ddir).
struct __align__(64) BwdMaps {
  CUtensorMap w[MAX_LAYERS + 1];
  CUtensorMap wt_trunk, wt_dir;
  CUtensorMap h, dpre;
  // K8: Wapp (HALF x E, boxes of 64 K x HALF), the stash's bf16 embeddings
  // (rows x E, boxes of 64 x 128) and Wapp^T (E x HALF, boxes of 64 x 64),
  // each zero past E
  CUtensorMap wapp, embr, wt_app;
};

struct __align__(64) DwMaps {
  CUtensorMap dpre, h, ddir;
};

// The backward scratch (field_bwd.cuh's Scratch; part holds 2 slots a
// tile), the per-CTA gate masks and the dW pass's partial blocks.
struct Scratch90 {
  Scratch s;
  uint4* gates;     // MAX_CTAS x gate sets x (L + 1) x CONSUMERS
  float* dwpart90;  // DW90_PARTS x blocks x 128 x 256
  int blocks;       // dW blocks on wgmma: 2 (L - 1) + 1
};

// The rays of a launch and the depths of each ray's s rows (K3, K7: its
// samples; K4, K6: its fine samples; K9: its coarse samples, then s_fine
// fine ones, whose depths the tile forms).  K8: R rows, o their points,
// rpc = ROWS, s = 1, no z.
struct BwdRays {
  const float* o;
  const float* d;
  const float* emb;
  const float* t;
  const float* z;
  long long R, ray_base, n_tiles;
  int s, rpc, s_fine;
};

inline int narrow_dw_tiles(const FieldArgs& P) {
  int n = dw_tiles_of(HID, P.kx);
  for (int i = 1; i < P.num_layers; ++i)
    if ((P.skip_mask >> i) & 1) n += dw_tiles_of(HID, P.kx);
  return n + dw_tiles_of(HALF, P.kd) + dw_tiles_of(HALF, P.emb_dim) + dw_tiles_of(DRGB_LD, HALF);
}

// Lay the scratch out from base (or only measure it, base == nullptr) for
// `tiles` tiles of rows and gate_sets sets of one tile's gate masks a CTA
// (K9: 2); returns its size in bytes.
inline long long carve90(char* base, const FieldArgs& P, long long tiles, int n_vecs,
                         Scratch90* s, int gate_sets = 1) {
  const long long rows = tiles * TILE_M;
  long long off = 0;
  auto take = [&](long long bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += (bytes + 1023) / 1024 * 1024;
    return p;
  };
  const long long b = sizeof(__nv_bfloat16);
  const int L = P.num_layers;
  Scratch& c = s->s;
  c.h = reinterpret_cast<__nv_bfloat16*>(take(L * rows * HID * b));
  c.dpre = reinterpret_cast<__nv_bfloat16*>(take(L * rows * HID * b));
  c.encx = reinterpret_cast<__nv_bfloat16*>(take(rows * P.kx * b));
  c.encd = reinterpret_cast<__nv_bfloat16*>(take(rows * P.kd * b));
  c.happ = reinterpret_cast<__nv_bfloat16*>(take(rows * HALF * b));
  c.dapp = reinterpret_cast<__nv_bfloat16*>(take(rows * HALF * b));
  c.ddir = reinterpret_cast<__nv_bfloat16*>(take(rows * HALF * b));
  c.drgb = reinterpret_cast<__nv_bfloat16*>(take(rows * DRGB_LD * b));
  c.embr = reinterpret_cast<__nv_bfloat16*>(take(rows * P.emb_dim * b));
  c.nv = n_vecs + 1;
  c.part = reinterpret_cast<float*>(take(2 * tiles * c.nv * (long long)sizeof(float)));
  c.dw_tiles = narrow_dw_tiles(P);  // the narrow jobs' 64 x 64 tiles (dw_kernel)
  c.dwpart = reinterpret_cast<float*>(
      take((long long)NARROW_PARTS * c.dw_tiles * DW_TILE * DW_TILE * sizeof(float)));
  c.rows = rows;
  s->gates = reinterpret_cast<uint4*>(take((long long)MAX_CTAS * gate_sets * (L + 1) * GATE_BYTES));
  s->blocks = 2 * (L - 1) + 1;
  s->dwpart90 = reinterpret_cast<float*>(
      take((long long)DW90_PARTS * s->blocks * DW90_ROWS * HID * sizeof(float)));
  return off;
}

// ---------------------------------------------------------------- primitives

// The box at (c0, c1) of `map` from shared memory at src (after the writers'
// fence.proxy.async and a barrier).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The issuing thread's stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma descriptor of an MN-major operand in 128-byte-swizzled 64-column
// boxes of 64 rows (8 KB each, side by side): the leading offset steps from
// one 64-column box to the next (8 KB), the stride from one 8-row group of
// the reduction index to the next (1 KB).
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define DANERF_ACC8(b)                                                                   \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),        \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 256 f32) += A (64 x 16) B (16 x 256), both MN-major in shared
// memory (the transpose bits set).
__device__ __forceinline__ void wgmma_n256_tt(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, 1, 1, 1, 1, 1;\n"
      : DANERF_ACC8(0), DANERF_ACC8(8), DANERF_ACC8(16), DANERF_ACC8(24), DANERF_ACC8(32),
        DANERF_ACC8(40), DANERF_ACC8(48), DANERF_ACC8(56), DANERF_ACC8(64), DANERF_ACC8(72),
        DANERF_ACC8(80), DANERF_ACC8(88), DANERF_ACC8(96), DANERF_ACC8(104), DANERF_ACC8(112),
        DANERF_ACC8(120)
      : "l"(da), "l"(db));
}

// d[0..31] (+)= A (64 x 16) B^T (64 x 16), both K-major: K8's per-row demb.
__device__ __forceinline__ void wgmma_n64(float (&d)[ACC], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : DANERF_ACC8(0), DANERF_ACC8(8), DANERF_ACC8(16), DANERF_ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef DANERF_ACC8

// The sum of v[q] (q = 2 jj + e: the thread's partial sum of column
// 8 (j0 + jj) + cq + e, jj < 4) over the 8 lanes that share lane & 3, as a
// reduce-scatter: three rounds of exchanging half the values, each lane
// keeping its half in a fixed order.  Returns the lane's column's sum,
// column colsum8_col(j0, lane).
__device__ __forceinline__ float colsum8(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  float a[4], b[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 16;
    a[k] = (hi ? v[4 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, hi ? v[k] : v[4 + k], 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 8;
    b[k] = (hi ? a[2 + k] : a[k]) + __shfl_xor_sync(0xffffffffu, hi ? a[k] : a[2 + k], 8);
  }
  const bool hi = lane & 4;
  return (hi ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, hi ? b[0] : b[1], 4);
}

// The column whose sum colsum8 leaves in lane: q = 4 bit4 + 2 bit3 + bit2
// of the lane.
__device__ __forceinline__ int colsum8_col(int j0, int lane) {
  const int q = (lane >> 2) & 7;
  return 8 * (j0 + (q >> 1)) + 2 * (lane & 3) + (q & 1);
}

// Four 8 x 8 bf16 tiles from v into the swizzled buffer at blk (rows 64 g..,
// one stmatrix): columns 8 j.. and 8 (j + 1).. (j even) of the thread's
// rows r0 and r0 + 8, as field_sm90.cuh's trunk_epilogue lays them out.
__device__ __forceinline__ void st_pair(uint32_t buf, int g, int j, const uint32_t (&v)[2][2]) {
  const int lane = threadIdx.x & 31;
  const int row = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t addr =
      buf + row * 128 + (j >> 3) * BLK + ((((j & 7) + (lane >> 4)) ^ (lane & 7)) << 4);
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0][0]), "r"(v[0][1]), "r"(v[1][0]), "r"(v[1][1])
               : "memory");
}

// A bf16 element of the swizzled 128-row buffer at p (64-column blocks).
__device__ __forceinline__ float act_at(const unsigned char* p, int row, int col) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(p + (col >> 6) * BLK + swz(row, col & 63, 128)));
}

__device__ __forceinline__ SmemBwd& smem_bwd() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return *reinterpret_cast<SmemBwd*>(smem_raw);
}

// Barriers: full / empty pace the ring (empty: both consumer warpgroups);
// enc_full when the encoders have filled the buffer, enc_empty when the
// consumers are done with it; app_full / app_empty (both warpgroups) the
// appearance term; comp_done when the consumers no longer use the ring for
// the composite; zf_ready (K9) when the consumers have written a tile's
// fine depths into the buffer.
__device__ __forceinline__ void init_bwd(SmemBwd& sm) {
  if (threadIdx.x == 0) {
    if (smem_u32(&sm) & 1023) __trap();
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    mbar_init(&sm.enc_full, 1);
    mbar_init(&sm.enc_empty, 1);
    mbar_init(&sm.app_full, 1);
    mbar_init(&sm.app_empty, 2);
    mbar_init(&sm.comp_done, 1);
    mbar_init(&sm.zf_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- producer

// The weight stream (the producer warpgroup's first thread): for every tile
// of this CTA, the forward's K slices (field_sm90.cuh stream_weights), then,
// once the composite is off the ring, the transposed chain's: the dir
// layer's block (2 slices), then the trunk layers' from the last to layer 1
// (4 each).  K8 takes one more stage after the forward's, once the
// encoders have stashed the tile's embeddings: Wapp and the rows'
// embeddings (the appearance product), and one before the chain's: Wapp^T
// (demb).  K9 streams the forward twice (coarse, fine) and the chain twice
// (fine, coarse).
template <int KIND>
__device__ __forceinline__ void stream_bwd(const BwdMaps& maps, const FieldArgs& P,
                                           long long n_tiles) {
  SmemBwd& sm = smem_bwd();
  const uint32_t ring = smem_u32(&sm);
  const uint32_t full = ring + offsetof(SmemBwd, full), empty = ring + offsetof(SmemBwd, empty);
  const int tiles = my_tiles(n_tiles);
  Pipe pp;
  auto load = [&](const CUtensorMap* m, int k0, int row, uint32_t at = 0) {
    tma_load_at(ring + pp.stage * STAGE_BYTES + at, m, k0, row, full + 8 * pp.stage);
  };
  auto stage = [&](uint32_t bytes) {  // wait for the stage, expect `bytes`
    mbar_wait_at(empty + 8 * pp.stage, pp.phase ^ 1);
    mbar_expect_tx(full + 8 * pp.stage, bytes);
  };
  auto forward = [&]() {
    for (int i = 0; i <= P.num_layers; ++i) {
      const uint32_t bytes = (i == P.num_layers ? HALF : HID) * KS * 2;
      for (int k0 = 0; k0 < layer_k(P, i); k0 += KS) {
        stage(bytes);
        load(&maps.w[i], k0, 0);
        pp.advance();
      }
    }
  };
  auto chain = [&]() {
    for (int k0 = 0; k0 < HALF; k0 += KS) {
      stage(STAGE_BYTES);
      load(&maps.wt_dir, k0, 0);
      pp.advance();
    }
    for (int i = P.num_layers - 1; i >= 1; --i)
      for (int k0 = 0; k0 < HID; k0 += KS) {
        stage(STAGE_BYTES);
        load(&maps.wt_trunk, k0, (i - 1) * HID);
        pp.advance();
      }
  };
  for (int c = 0; c < tiles; ++c) {
    forward();
    if constexpr (KIND == ROW_TILE) {
      const int row0 = (int)((blockIdx.x + (long long)c * gridDim.x) * ROWS);
      mbar_wait(&sm.enc_full, c & 1);  // the tile's embeddings are in the stash
      stage(2 * HALF * KS * 2);
      load(&maps.wapp, 0, 0);
      load(&maps.embr, 0, row0, HALF * KS * 2);
      pp.advance();
    }
    if constexpr (KIND == HIER) forward();
    mbar_wait(&sm.comp_done, c & 1);
    if constexpr (KIND == ROW_TILE) {
      stage(2 * 64 * KS * 2);
      load(&maps.wt_app, 0, 0);
      load(&maps.wt_app, KS, 0, 64 * KS * 2);
      pp.advance();
    }
    chain();
    if constexpr (KIND == HIER) chain();
  }
}

// The encoders (96 threads): for each tile of this CTA, once the consumers
// have handed the buffer back, load the tile's rays and depths and encode
// every row (field_sm90.cuh encode_group), publish the buffer, write the
// encodings and each row's bf16 embedding (zeros past the tile's rays) to
// the stash; then, once the consumers have read the previous tile's
// appearance term, form this one's.  K8: each row's point, direction and
// time straight from device memory, and the embeddings stashed before the
// buffer is published (the producer loads them for the appearance
// product); no per-ray term.  K9: then, once the consumers have written
// the tile's fine depths into the buffer (after its coarse forward), the
// fine rows, published and stashed likewise at the tile's second row set.
template <int KIND>
__device__ __forceinline__ void encode_bwd(const FieldArgs& P, const BwdRays& rays,
                                           const Scratch& sc) {
  SmemBwd& sm = smem_bwd();
  EncBuf& eb = sm.enc;
  const int et = threadIdx.x - ENC0;
  const int rpc = rays.rpc, tiles = my_tiles(rays.n_tiles), E = P.emb_dim;
  const EncPitch pt{seg_pitch(min(P.kx, KS)), seg_pitch(P.kx - KS), seg_pitch(P.kd)};
  const int items = ROWS * (P.pos_levels + P.dir_levels + 1);
  const __nv_bfloat16* wapp = P.mats + P.wapp_off;
  // each row's bf16 embedding (its ray's; zeros past the tile's rays) to the
  // stash rows row0..
  auto stash_emb = [&](int s, long long ray0, long long row0) {
    for (int idx = et; idx < ROWS * E; idx += ENCODERS) {
      const int row = idx / E, k = idx - row * E, j = row / s;
      const long long r = ray0 + j;
      sc.embr[(row0 + row) * E + k] =
          __float2bfloat16_rn(j < rpc && r < rays.R ? rays.emb[r * E + k] : 0.f);
    }
  };
  // the encodings of the buffer's rows (s samples a ray) into the buffer,
  // published; then to the stash rows row0..
  auto encode = [&](int s, long long ray0, long long row0) {
    const float inv_s = 1.f / (float)s;
    for (int it = et; it < items; it += ENCODERS) {
      const int row = it & (ROWS - 1);
      if constexpr (KIND == ROW_TILE) {
        const long long r = ray0 + row, rc = r < rays.R ? r : rays.R - 1;
        encode_group_at(P, eb, pt, row, it >> 7, r < rays.R, rays.o + rc * 3, rays.d + rc * 3,
                        nullptr, rays.t != nullptr ? rays.t + rc : nullptr);
      } else {
        const int j = __float2int_rz(((float)row + 0.5f) * inv_s);  // row / s, exactly
        encode_group(P, eb, pt, row, it >> 7, j, rpc);
      }
    }
    fence_proxy_async();
    if constexpr (KIND == ROW_TILE) {
      stash_emb(s, ray0, row0);  // which the producer's TMA reads next
      fence_proxy_async_global();
    }
    encoders_sync();
    if (et == 0) mbar_arrive(&sm.enc_full);
    // the stash: encx (rows x kx), encd (rows x kd), 16 bytes an item
    const int cx = P.kx / 8, cd = P.kd / 8;
    for (int it = et; it < ROWS * (cx + cd); it += ENCODERS) {
      const int row = it / (cx + cd), q = it - row * (cx + cd);
      const unsigned char* src;
      __nv_bfloat16* dst;
      if (q < cx) {
        src = q < KS / 8 ? eb.encx + swz(row, 8 * q, pt.x0)
                         : eb.encx + BLK + swz(row, 8 * q - KS, pt.x1);
        dst = sc.encx + (row0 + row) * P.kx + 8 * q;
      } else {
        src = eb.encd + swz(row, 8 * (q - cx), pt.d);
        dst = sc.encd + (row0 + row) * P.kd + 8 * (q - cx);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    }
    if constexpr (KIND != ROW_TILE) stash_emb(s, ray0, row0);
  };
  for (int c = 0; c < tiles; ++c) {
    const long long tile = blockIdx.x + (long long)c * gridDim.x;
    const long long ray0 = rays.ray_base + tile * rpc;
    const long long row0 = (KIND == HIER ? 2 * tile : tile) * ROWS;
    mbar_wait(&sm.enc_empty, (c & 1) ^ 1);
    if constexpr (KIND != ROW_TILE) {
      const int s = rays.s;
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
    }
    encode(rays.s, ray0, row0);
    if constexpr (KIND != ROW_TILE) {
      mbar_wait(&sm.app_empty, (c & 1) ^ 1);
      for (int idx = et; idx < rpc * HALF; idx += ENCODERS) {
        const int j = idx / HALF, n = idx - j * HALF;
        const long long r = ray0 + j;
        float acc = 0.f;
        if (r < rays.R)
          for (int k = 0; k < E; ++k)
            acc += bf16_round(rays.emb[r * E + k]) * __bfloat162float(wapp[n * E + k]);
        sm.app[idx] = acc;
      }
      encoders_sync();
      if (et == 0) mbar_arrive(&sm.app_full);
    }
    if constexpr (KIND == HIER) {
      mbar_wait(&sm.zf_ready, c & 1);  // the fine depths are in eb.z
      encode(rays.s_fine, ray0, row0 + ROWS);
    }
  }
}

// ---------------------------------------------------------------- consumers

// acc = A @ B^T over n_slices K slices of the ring for warpgroup g's 64 rows,
// A's slice s the segment seg(s); each stage released as soon as its products
// are done (field_sm90.cuh mma_layer).
template <int N, class SegFn>
__device__ __forceinline__ void mma_ring(float (&acc)[ACC], SmemBwd& sm, int n_slices, int g,
                                         Pipe& pp, SegFn seg) {
  // the products overwrite acc (scale_d = 0 first); zeroing it ends the
  // live range of the previous values, so the code between products keeps
  // no accumulator registers
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = 0.f;
  int prev = -1;
  for (int s = 0; s < n_slices; ++s) {
    mbar_wait(&sm.full[pp.stage], pp.phase);
    __syncwarp();
    const Seg sg = seg(s);
    const uint64_t da = make_desc(sg.addr + g * 64 * sg.pitch, sg.pitch);
    const uint64_t db = make_desc(smem_u32(sm.ring[pp.stage]), 128);
    wgmma_fence();
    for (int k = 0; k < sg.kw / 16; ++k) {
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

// Before warpgroup g overwrites its rows of sm.act: its last TMA store has
// read them and every warp's products have.
__device__ __forceinline__ void act_free(int g) {
  if ((threadIdx.x & 127) == 0) bulk_wait_read();
  wg_sync(g);
}

// After warpgroup g has written its rows of sm.act: store them, 4 boxes of
// 64 x 64, to rows `row` .. of `map`.
__device__ __forceinline__ void act_store(const CUtensorMap* map, SmemBwd& sm, int g, int row) {
  fence_proxy_async();
  wg_sync(g);
  if ((threadIdx.x & 127) == 0) {
    for (int q = 0; q < 4; ++q) tma_store(map, smem_u32(sm.act + q * BLK + g * 64 * 128), 64 * q, row);
    bulk_commit();
  }
}

// A trunk layer's forward epilogue (field_sm90.cuh trunk_epilogue) that also
// keeps the thread's relu gates, set where the bf16 output is non-zero:
// word 2 h + (j >> 4) of mask, bit j & 15 for column 8 j + cq of row r0 +
// 8 h and bit 16 + (j & 15) for column 8 j + cq + 1.
template <bool LAST>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[ACC], const float* bias,
                                             const float* wd, SmemBwd& sm, int g,
                                             float (&dsum)[2], uint32_t (&mask)[4]) {
  const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  const uint32_t buf = smem_u32(sm.act);
#pragma unroll
  for (int q = 0; q < 4; ++q) mask[q] = 0u;
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
        // bit 15 / 31: the low / high half's magnitude is non-zero (a relu
        // output is below 0x7f80, so the add carries out of neither half)
        const uint32_t nz = ((v[jj][h] & 0x7fff7fffu) + 0x7fff7fffu) & 0x80008000u;
        mask[2 * h + ((j + jj) >> 4)] |= nz >> (15 - ((j + jj) & 15));
        if constexpr (LAST) {
          const float2 w = __ldg(reinterpret_cast<const float2*>(wd + c));
          dsum[h] += __uint_as_float(v[jj][h] << 16) * w.x +
                     __uint_as_float(v[jj][h] & 0xffff0000u) * w.y;
        }
      }
    }
    st_pair(buf, g, j, v);
  }
}

// The forward on tile c (the c-th of this CTA, scratch rows row0..) for the
// calling consumer warpgroup: field_sm90.cuh field_tile90's, with each trunk
// layer's output TMA-stored to the stash and its gates to this CTA's gate
// area (the dir layer's, bit 2 j + e of word h for j < 16, after the trunk
// layers'), sigma_pre kept, happ written to the stash.  Leaves sm.rgb,
// sm.sigma, sm.sigma_pre valid behind a consumers_sync, and the last trunk
// output in sm.act.  enc_par: the parity of the buffer's fill (K9: 0 for a
// tile's coarse rows, 1 for its fine ones); app_done: hand the appearance
// term back (K9: after the fine rows).  K8 (ROW_TILE): the appearance term
// of each row is emb @ Wapp^T on wgmma from one more ring stage (Wapp, the
// rows' embeddings), into acc[64..127] beside the dir layer's accumulator.
template <int KIND>
__device__ __forceinline__ void forward_tile(const FieldArgs& P, const BwdMaps& maps, SmemBwd& sm,
                                             const Scratch& sc, uint4* gates, int c, int enc_par,
                                             bool app_done, long long row0, int s, int rpc,
                                             Pipe& pp, float (&acc)[ACC]) {
  const int g = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int r0 = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int L = P.num_layers;
  const EncBuf& eb = sm.enc;
  mbar_wait(&sm.enc_full, enc_par);

  for (int i = 0; i < L; ++i) {
    mma_ring<HID>(acc, sm, (layer_k(P, i) + KS - 1) / KS, g, pp, [&](int sl) -> Seg {
      if (i == 0) return encx_seg(eb, P, sl);
      if (sl < HID / KS) return {smem_u32(sm.act + sl * BLK), 128, KS};
      return encx_seg(eb, P, sl - HID / KS);
    });
    act_free(g);
    const float* bias = P.vecs + P.b_off[i];
    float dsum[2] = {0.f, 0.f};
    uint32_t mask[4];
    if (i == L - 1) {
      fwd_epilogue<true>(acc, bias, P.vecs + P.wd_off, sm, g, dsum, mask);
      const float bd = __ldg(P.vecs + P.bd_off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dsum[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += bd;
        if ((lane & 3) == 0) {
          sm.sigma_pre[r0 + 8 * h] = v;
          sm.sigma[r0 + 8 * h] =
              P.softplus ? fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) : fmaxf(v, 0.f);
        }
      }
    } else {
      fwd_epilogue<false>(acc, bias, nullptr, sm, g, dsum, mask);
    }
    gates[i * CONSUMERS + threadIdx.x] = make_uint4(mask[0], mask[1], mask[2], mask[3]);
    act_store(&maps.h, sm, g, (int)(i * sc.rows + row0 + 64 * g));
  }

  // dir branch and rgb head (field_tile90's), happ to the stash
  mma_ring<HALF>(acc, sm, (layer_k(P, L) + KS - 1) / KS, g, pp, [&](int sl) -> Seg {
    if (sl < HID / KS) return {smem_u32(sm.act + sl * BLK), 128, KS};
    return {smem_u32(eb.encd), seg_pitch(P.kd), P.kd};
  });
  if constexpr (KIND == ROW_TILE) {
    app_rows_mma(acc, smem_u32(&sm), sm.full, sm.empty, P.emb_dim, g, pp);
  } else {
    mbar_wait(&sm.app_full, c & 1);
  }
  {
    const float* bdir = P.vecs + P.bdir_off;
    const float* bapp = P.vecs + P.bapp_off;
    const __nv_bfloat16* wrgb = P.mats + P.wrgb_off;
    const float* app[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) app[h] = sm.app + min((r0 + 8 * h) / s, rpc - 1) * HALF;
    float cs[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    uint32_t dmask[2] = {0u, 0u};
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
        dmask[h] |= ((uint32_t)(p0 > 0.f) | ((uint32_t)(p1 > 0.f) << 1)) << (2 * j);
        const float e0 = KIND == ROW_TILE ? acc[64 + 4 * j + 2 * h] : app[h][c8];
        const float e1 = KIND == ROW_TILE ? acc[64 + 4 * j + 2 * h + 1] : app[h][c8 + 1];
        const float h0 = bf16_round((fmaxf(p0, 0.f) + e0) + ba2.x);
        const float h1 = bf16_round((fmaxf(p1, 0.f) + e1) + ba2.y);
        *reinterpret_cast<uint32_t*>(sc.happ + (row0 + r0 + 8 * h) * HALF + c8) = bf16x2(h0, h1);
#pragma unroll
        for (int k = 0; k < 3; ++k) cs[h][k] += h0 * w[k].x + h1 * w[k].y;
      }
    }
    gates[L * CONSUMERS + threadIdx.x] = make_uint4(dmask[0], dmask[1], 0u, 0u);
    if (KIND != ROW_TILE && app_done) {
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

// Stable rank merge of one ray's samples by one warp, keeping the ranks:
// the sorted coarse depths zc (Sc) with their field fc ((4, Sc)) and the
// sorted fine depths zf (Sf) whose field is at rows row0.. of rgb_s /
// sig_s; rank_c = i + #{z_f < z_c[i]}, rank_f = j + #{z_c <= z_f[j]}
// (coarse first on ties) replaces the TPU kernel's one-hot permutation
// matmuls.
__device__ __forceinline__ void merge_ray_ranks(const float* rgb_s, const float* sig_s,
                                                const float* zc, int Sc, const float* zf, int Sf,
                                                const float* __restrict__ fc, int row0, float* mz,
                                                float* msig, float* mrgb, int* rank_c,
                                                int* rank_f) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < Sc; i += 32) {
    const float zv = zc[i];
    int cnt = 0;
    for (int k = 0; k < Sf; ++k) cnt += zf[k] < zv;
    const int k = i + cnt;
    rank_c[i] = k;
    mz[k] = zv;
    mrgb[k * 3 + 0] = fc[i];
    mrgb[k * 3 + 1] = fc[Sc + i];
    mrgb[k * 3 + 2] = fc[2 * Sc + i];
    msig[k] = fc[3 * Sc + i];
  }
  for (int i = lane; i < Sf; i += 32) {
    const float zv = zf[i];
    int cnt = 0;
    for (int k = 0; k < Sc; ++k) cnt += zc[k] <= zv;
    const int k = i + cnt;
    const int row = row0 + i;
    rank_f[i] = k;
    mz[k] = zv;
    mrgb[k * 3 + 0] = rgb_s[row * 3 + 0];
    mrgb[k * 3 + 1] = rgb_s[row * 3 + 1];
    mrgb[k * 3 + 2] = rgb_s[row * 3 + 2];
    msig[k] = sig_s[row];
  }
  __syncwarp();
}

// The ray march's composite: the forward over each ray's own S samples kept,
// its transpose under the cotangents of ray_cotangents<MSE> (K3: the
// caller's, plus the field's own cotangent g_field (R, 4, S), null for none;
// K7: the MSE's, g_field null); one warp per ray, the per-warp alpha / T / w
// in the ring.
template <bool MSE_>
struct MarchComp {
  static constexpr bool MSE = MSE_;
  static constexpr int KIND = RAYS;
  RayCot cot;
  const float* g_field;
  int S;
  __device__ void operator()(SmemBwd& sm, long long ray0, int nvalid, int rpc) const {
    float* cscr = reinterpret_cast<float*>(sm.ring);
    BwdSmem& bs = sm.bs;
    const float* z = sm.enc.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < nvalid; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      float* al = cscr + warp * 3 * S;
      float out[5], g[5];
      const float* gw;
      composite_keep(z + j * S, sm.sigma + j * S, sm.rgb + j * S * 3, S, al, al + S, al + 2 * S,
                     out);
      ray_cotangents<MSE>(cot, r, S, out, g, &gw, bs.loss + j);
      composite_bwd(z + j * S, sm.rgb + j * S * 3, S, al, al + S, al + 2 * S, out[3], out[4],
                    g[0], g[1], g[2], g[3], g[4], gw, bs.g_rgb + j * S * 3, bs.g_sig + j * S);
      if (!MSE && g_field != nullptr) {
        __syncwarp();
        const float* gf = g_field + r * 4 * S;
        for (int k = lane; k < S; k += 32) {
          const int row = j * S + k;
          bs.g_rgb[row * 3 + 0] += gf[k];
          bs.g_rgb[row * 3 + 1] += gf[S + k];
          bs.g_rgb[row * 3 + 2] += gf[2 * S + k];
          bs.g_sig[row] += gf[3 * S + k];
        }
      }
    }
  }
};

// One ray's merged composite by one warp (K4, K6, K9): the fine rows j Sf..
// of sm.rgb / sm.sigma (depths zf) merged by rank with the coarse field fc
// ((4, Sc), depths zc), the composite over Sa = Sc + Sf and its transpose
// under the cotangents of ray_cotangents<MSE> (the loss term to
// bs.loss[j]), the un-permute by the kept ranks to the coarse field's
// cotangent gf ((4, Sc)) and the fine rows' bs.g_rgb / bs.g_sig.  al: the
// alpha / T / w (3 Sa), m: the merged z, sigma, rgb and the ranks (6 Sa).
template <bool MSE>
__device__ __forceinline__ void merged_ray(SmemBwd& sm, const RayCot& cot, long long r, int j,
                                           const float* zc, int Sc, const float* zf, int Sf,
                                           const float* fc, float* gf, float* al, float* m) {
  const int Sa = Sc + Sf, lane = threadIdx.x & 31;
  float* mz = m;
  float* msig = mz + Sa;
  float* mrgb = msig + Sa;
  int* rank_c = reinterpret_cast<int*>(mrgb + 3 * Sa);
  int* rank_f = rank_c + Sc;
  BwdSmem& bs = sm.bs;
  merge_ray_ranks(sm.rgb, sm.sigma, zc, Sc, zf, Sf, fc, j * Sf, mz, msig, mrgb, rank_c, rank_f);
  float out[5], g[5];
  const float* gw;
  composite_keep(mz, msig, mrgb, Sa, al, al + Sa, al + 2 * Sa, out);
  ray_cotangents<MSE>(cot, r, Sa, out, g, &gw, bs.loss + j);
  // the transpose overwrites the merged rgb / sigma with their cotangents
  composite_bwd(mz, mrgb, Sa, al, al + Sa, al + 2 * Sa, out[3], out[4], g[0], g[1], g[2], g[3],
                g[4], gw, mrgb, msig);
  __syncwarp();
  for (int i = lane; i < Sc; i += 32) {
    const int k = rank_c[i];
    gf[i] = mrgb[k * 3 + 0];
    gf[Sc + i] = mrgb[k * 3 + 1];
    gf[2 * Sc + i] = mrgb[k * 3 + 2];
    gf[3 * Sc + i] = msig[k];
  }
  for (int i = lane; i < Sf; i += 32) {
    const int k = rank_f[i];
    const int row = j * Sf + i;
    bs.g_rgb[row * 3 + 0] = mrgb[k * 3 + 0];
    bs.g_rgb[row * 3 + 1] = mrgb[k * 3 + 1];
    bs.g_rgb[row * 3 + 2] = mrgb[k * 3 + 2];
    bs.g_sig[row] = msig[k];
  }
}

// The merged composite: merged_ray for each ray under the cotangents of
// ray_cotangents<MSE> (K4: the MSE's; K6: the caller's, g_w (R, Sc + Sf) in
// merged order, the depth cotangent through the merged depth and acc), the
// coarse field's cotangent to g_field (R, 4, Sc).  Its arrays (the per-warp
// alpha / T / w, the coarse depths and the merge arrays of each ray) in the
// ring.
template <bool MSE_>
struct MergedComp {
  static constexpr bool MSE = MSE_;
  static constexpr int KIND = RAYS;
  RayCot cot;
  const float* zc;
  const float* fc;
  float* gfield;
  long long R;
  int Sc, Sf;
  __device__ void operator()(SmemBwd& sm, long long ray0, int nvalid, int rpc) const {
    const int Sa = Sc + Sf;
    float* cscr = reinterpret_cast<float*>(sm.ring);
    float* zc_s = cscr + (CONSUMERS / 32) * 3 * Sa;  // rpc x Sc
    float* merge = zc_s + rpc * Sc;                   // rpc x 6 Sa
    for (int idx = threadIdx.x; idx < rpc * Sc; idx += CONSUMERS) {
      const long long r = ray0 + idx / Sc;
      zc_s[idx] = r < R ? zc[r * Sc + idx % Sc] : 0.f;
    }
    consumers_sync();
    const int warp = threadIdx.x >> 5;
    for (int j = warp; j < nvalid; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      merged_ray<MSE>(sm, cot, r, j, zc_s + j * Sc, Sc, sm.enc.z + j * Sf, Sf, fc + r * 4 * Sc,
                      gfield + r * 4 * Sc, cscr + warp * 3 * Sa, merge + j * 6 * Sa);
    }
  }
};

// K8's "composite": each row's cotangents are the caller's g_rgb (N,3) and
// g_sigma (N) (rows ray0.., nvalid of them).
struct RowComp {
  static constexpr bool MSE = false;
  static constexpr int KIND = ROW_TILE;
  const float* g_rgb;
  const float* g_sigma;
  __device__ void operator()(SmemBwd& sm, long long ray0, int nvalid, int rpc) const {
    for (int r = threadIdx.x; r < nvalid; r += CONSUMERS) {
      sm.bs.g_rgb[r * 3 + 0] = g_rgb[(ray0 + r) * 3 + 0];
      sm.bs.g_rgb[r * 3 + 1] = g_rgb[(ray0 + r) * 3 + 1];
      sm.bs.g_rgb[r * 3 + 2] = g_rgb[(ray0 + r) * 3 + 2];
      sm.bs.g_sig[r] = g_sigma[ray0 + r];
    }
  }
};

// Warpgroup g's slot of the tile's row sums: out[col] = the sum of its four
// warps' column sums (after a wg_sync), for col < n.
__device__ __forceinline__ void colsum_out(const SmemBwd& sm, int g, float* out, int off, int n) {
  for (int col = threadIdx.x & 127; col < n; col += 128)
    out[col] = ((sm.colsum[g][0][off + col] + sm.colsum[g][1][off + col]) +
                sm.colsum[g][2][off + col]) + sm.colsum[g][3][off + col];
}

// The chain's head after the composite (bs.g_rgb / bs.g_sig set for every
// row, zero on rows of no ray): d_pre_rgb (stashed as bf16) and d_sigma_pre
// per row, the rgb head's and density head's row sums (wd from the last
// trunk output: in sm.act, or, h_last non-null, the stash's rows at
// h_last), then on the dir layer's fragments d_happ = bf16(d_pre_rgb) @ Wrgb
// and d_hdir_pre = gate ? d_happ : 0, both stashed as bf16 and written into
// sm.act (blocks 0-1 d_hdir_pre, the A operand of the first transposed
// product; blocks 2-3 d_happ), with the bapp / bdir row sums; then demb =
// (the sum over each ray's rows of bf16(d_happ)) @ Wapp, added to demb's
// rows where add_demb (K9's coarse rows).  K8 (ROW_TILE): demb = bf16(d_happ)
// @ Wapp per row on wgmma, B = Wapp^T from the ring (one stage, zero past
// E), A = blocks 2-3 of sm.act, into acc[0..31].  row0 / tile: the stash
// rows and the row-sum slots; ray0: the first ray (K8: row) of demb.
template <int KIND>
__device__ __forceinline__ void chain_head(const FieldArgs& P, SmemBwd& sm, const Scratch& sc,
                                           const uint4* gates, long long tile, long long row0,
                                           int s, int nvalid, long long ray0,
                                           float* __restrict__ demb, bool add_demb,
                                           const __nv_bfloat16* h_last, Pipe& pp,
                                           float (&acc)[ACC]) {
  const int g = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = P.emb_dim;
  BwdSmem& bs = sm.bs;
  float* part0 = sc.part + 2 * tile * sc.nv;
  for (int r = threadIdx.x; r < ROWS; r += CONSUMERS) {
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float y = sm.rgb[r * 3 + c];
      v[c] = bs.g_rgb[r * 3 + c] * y * (1.f - y);
      bs.dpr[r * 3 + c] = v[c];
    }
    uint4* dst = reinterpret_cast<uint4*>(sc.drgb + (row0 + r) * DRGB_LD);
    dst[0] = make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], 0.f), 0u, 0u);
    dst[1] = make_uint4(0u, 0u, 0u, 0u);
    const float sp = sm.sigma_pre[r];
    const float act = P.softplus ? 1.f / (1.f + expf(-sp)) : (sp > 0.f ? 1.f : 0.f);
    bs.dsp[r] = bs.g_sig[r] * act;
  }
  consumers_sync();
  if (warp == 0) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, ad = 0.f;
    for (int r = lane; r < ROWS; r += 32) {
      a0 += bs.dpr[r * 3 + 0]; a1 += bs.dpr[r * 3 + 1]; a2 += bs.dpr[r * 3 + 2];
      ad += bs.dsp[r];
    }
    a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2); ad = warp_sum(ad);
    if (lane == 0) {
      part0[P.brgb_off + 0] = a0; part0[P.brgb_off + 1] = a1; part0[P.brgb_off + 2] = a2;
      part0[P.bd_off] = ad;
    }
  }
  {
    const int col = threadIdx.x;  // CONSUMERS == HID
    float a = 0.f;
    if (h_last == nullptr) {
      for (int r = 0; r < ROWS; ++r) a += act_at(sm.act, r, col) * bs.dsp[r];
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(h_last) + col;
      for (int r = 0; r < ROWS; ++r)
        a += __uint_as_float((uint32_t)__ldcg(h + (long long)r * HID) << 16) * bs.dsp[r];
    }
    part0[P.wd_off + col] = a;
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_read();  // the last trunk layer's store
  consumers_sync();

  {
    const int cq = 2 * (lane & 3);
    const int r0 = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const __nv_bfloat16* wrgb = P.mats + P.wrgb_off;
    const uint32_t buf = smem_u32(sm.act);
    const uint4 dm = gates[P.num_layers * CONSUMERS + threadIdx.x];
    const uint32_t dmask[2] = {dm.x, dm.y};
    float dp[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 3; ++k) dp[h][k] = bf16_round(bs.dpr[(r0 + 8 * h) * 3 + k]);
#pragma unroll
    for (int j0 = 0; j0 < HALF / 8; j0 += 4) {
      float sa[8], sd[8];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t va[2][2], vd[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int jc = j0 + j + jj, c = 8 * jc + cq;
          float2 w[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            w[k] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(wrgb + k * HALF + c));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dh0 = dp[h][0] * w[0].x + dp[h][1] * w[1].x + dp[h][2] * w[2].x;
            const float dh1 = dp[h][0] * w[0].y + dp[h][1] * w[1].y + dp[h][2] * w[2].y;
            const uint32_t bits = dmask[h] >> (2 * jc);
            const float g0 = (bits & 1u) ? dh0 : 0.f, g1 = (bits & 2u) ? dh1 : 0.f;
            va[jj][h] = bf16x2(dh0, dh1);
            vd[jj][h] = bf16x2(g0, g1);
            const long long at = (row0 + r0 + 8 * h) * HALF + c;
            *reinterpret_cast<uint32_t*>(sc.dapp + at) = va[jj][h];
            *reinterpret_cast<uint32_t*>(sc.ddir + at) = vd[jj][h];
            const int q = 2 * (j + jj);
            sa[q] = h ? sa[q] + dh0 : dh0;
            sa[q + 1] = h ? sa[q + 1] + dh1 : dh1;
            sd[q] = h ? sd[q] + g0 : g0;
            sd[q + 1] = h ? sd[q + 1] + g1 : g1;
          }
        }
        st_pair(buf, g, j0 + j, vd);
        st_pair(buf + 2 * BLK, g, j0 + j, va);
      }
      const float a = colsum8(sa), d = colsum8(sd);
      const int col = colsum8_col(j0, lane);
      sm.colsum[g][warp & 3][col] = a;
      sm.colsum[g][warp & 3][HALF + col] = d;
    }
    fence_proxy_async();
    wg_sync(g);
    float* partg = part0 + g * sc.nv;
    colsum_out(sm, g, partg + P.bapp_off, 0, HALF);
    colsum_out(sm, g, partg + P.bdir_off, HALF, HALF);
  }
  if constexpr (KIND == ROW_TILE) {
    mbar_wait(&sm.full[pp.stage], pp.phase);
    __syncwarp();
    const uint32_t st = smem_u32(sm.ring[pp.stage]);
    const uint32_t a0 = smem_u32(sm.act + 2 * BLK) + g * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 2; ++q)  // K = HALF: two 64-column blocks
#pragma unroll
      for (int k = 0; k < KS / 16; ++k)
        wgmma_n64(acc, make_desc(a0 + q * BLK, 128) + 2 * k,
                  make_desc(st + q * 64 * KS * 2, 128) + 2 * k, (q | k) != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[pp.stage]);
    pp.advance();
    const int cq = 2 * (lane & 3);
    const int r0 = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = 8 * j + cq;
        if (r < nvalid && c < E) {
          demb[(ray0 + r) * E + c] = acc[4 * j + 2 * h];
          demb[(ray0 + r) * E + c + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    consumers_sync();  // every warpgroup's products have read sm.act
  } else {
    consumers_sync();
    for (int idx = threadIdx.x; idx < nvalid * HALF; idx += CONSUMERS) {
      const int j = idx / HALF, col = idx - j * HALF;
      float a = 0.f;
      for (int r = j * s; r < (j + 1) * s; ++r) a += act_at(sm.act + 2 * BLK, r, col);
      bs.dsum[idx] = a;
    }
    consumers_sync();
    const __nv_bfloat16* wapp = P.mats + P.wapp_off;
    for (int idx = threadIdx.x; idx < nvalid * E; idx += CONSUMERS) {
      const int j = idx / E, e = idx - j * E;
      float a = 0.f;
      for (int c = 0; c < HALF; ++c) a += bs.dsum[j * HALF + c] * __bfloat162float(wapp[c * E + e]);
      float* out = demb + (ray0 + j) * E + e;
      *out = add_demb ? *out + a : a;
    }
  }
}

// A transposed product's epilogue for warpgroup g: d_pre = gate ? acc (+
// d_sigma_pre wd for DIR) : 0 with the thread's gate masks m, rounded to
// bf16 into sm.act, the f32 column sums into sm.colsum[g].  m: the masks
// of fwd_epilogue (x, y row r0; z, w row r0 + 8).
template <bool DIR>
__device__ __forceinline__ void chain_epilogue(const float (&acc)[ACC], const uint4 m,
                                               const float* dsp, const float* wd, SmemBwd& sm,
                                               int g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  const int r0 = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  float ds[2] = {0.f, 0.f};
  if constexpr (DIR) {
    ds[0] = dsp[r0];
    ds[1] = dsp[r0 + 8];
  }
  const uint32_t buf = smem_u32(sm.act);
#pragma unroll
  for (int j0 = 0; j0 < HID / 8; j0 += 4) {
    float cs[8];
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t v[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int jc = j0 + j + jj, c = 8 * jc + cq;
        float2 w = make_float2(0.f, 0.f);
        if constexpr (DIR) w = __ldg(reinterpret_cast<const float2*>(wd + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t word = jc < 16 ? (h ? m.z : m.x) : (h ? m.w : m.y);
          const uint32_t bits = word >> (jc & 15);
          float v0 = acc[4 * jc + 2 * h], v1 = acc[4 * jc + 2 * h + 1];
          if constexpr (DIR) {
            v0 += ds[h] * w.x;
            v1 += ds[h] * w.y;
          }
          const float d0 = (bits & 1u) ? v0 : 0.f, d1 = (bits & 0x10000u) ? v1 : 0.f;
          const int q = 2 * (j + jj);
          cs[q] = h ? cs[q] + d0 : d0;
          cs[q + 1] = h ? cs[q + 1] + d1 : d1;
          v[jj][h] = bf16x2(d0, d1);
        }
      }
      st_pair(buf, g, j0 + j, v);
    }
    sm.colsum[g][warp & 3][colsum8_col(j0, lane)] = colsum8(cs);
  }
}

// The transposed chain on the tile: the dir layer's block (A = bf16
// d_hdir_pre in sm.act, K = HALF) gives d_pre of the last trunk layer, then
// trunk layer i's block (A = bf16 d_pre_i in place) d_pre_{i-1}, down to
// d_pre_0; each stashed and its bias sums written to warpgroup g's slot.
__device__ __forceinline__ void chain(const FieldArgs& P, const BwdMaps& maps, SmemBwd& sm,
                                      const Scratch& sc, const uint4* gates, long long tile,
                                      long long row0, Pipe& pp, float (&acc)[ACC]) {
  const int g = threadIdx.x >> 7;
  float* partg = sc.part + (2 * tile + g) * sc.nv;
  for (int i = P.num_layers; i >= 1; --i) {
    const uint4 m = gates[(i - 1) * CONSUMERS + threadIdx.x];
    mma_ring<HID>(acc, sm, (i == P.num_layers ? HALF : HID) / KS, g, pp,
                  [&](int sl) -> Seg { return {smem_u32(sm.act + sl * BLK), 128, KS}; });
    act_free(g);
    if (i == P.num_layers)
      chain_epilogue<true>(acc, m, sm.bs.dsp, P.vecs + P.wd_off, sm, g);
    else
      chain_epilogue<false>(acc, m, nullptr, nullptr, sm, g);
    act_store(&maps.dpre, sm, g, (int)((i - 1) * sc.rows + row0 + 64 * g));
    colsum_out(sm, g, partg + P.b_off[i - 1], 0, HID);
  }
}

// The producer warpgroup of a tile kernel: gives registers up, then its
// first thread streams the weights and its warps 1-3 encode.
template <int KIND>
__device__ __forceinline__ void produce_bwd(const BwdMaps& maps, const FieldArgs& P,
                                            const BwdRays& rays, const Scratch& sc) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
  if (threadIdx.x >= ENC0)
    encode_bwd<KIND>(P, rays, sc);
  else if (threadIdx.x == CONSUMERS)
    stream_bwd<KIND>(maps, P, rays.n_tiles);
}

// The tile kernel (pass 1) of K3, K4, K6, K7 (rays) and K8 (rows): for each
// tile of this CTA, the forward with its residuals, the composite and its
// transpose (comp; K8: the caller's per-row cotangents), the chain's head
// and the transposed chain.  gates_all: the per-CTA gate areas.
template <class Comp>
__global__ void __launch_bounds__(THREADS90, 1)
bwd_tile90(const __grid_constant__ BwdMaps maps, const FieldArgs P, const Scratch sc,
           uint4* __restrict__ gates_all, const BwdRays rays, const Comp comp,
           float* __restrict__ demb) {
  constexpr int KIND = Comp::KIND;
  SmemBwd& sm = smem_bwd();
  init_bwd(sm);
  if (is_producer()) {
    produce_bwd<KIND>(maps, P, rays, sc);
    return;
  }
  consumer_regs();
  uint4* gates = gates_all + (long long)blockIdx.x * (P.num_layers + 1) * CONSUMERS;
  const int s = rays.s, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  Pipe pp;
  float acc[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long tile = blockIdx.x + (long long)c * gridDim.x;
    const long long ray0 = rays.ray_base + tile * rpc, row0 = tile * ROWS;
    const int nvalid = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    for (int r = threadIdx.x; r < ROWS; r += CONSUMERS) {
      sm.bs.g_sig[r] = 0.f;
      sm.bs.g_rgb[r * 3 + 0] = 0.f; sm.bs.g_rgb[r * 3 + 1] = 0.f; sm.bs.g_rgb[r * 3 + 2] = 0.f;
    }
    forward_tile<KIND>(P, maps, sm, sc, gates, c, c & 1, true, row0, s, rpc, pp, acc);
    comp(sm, ray0, nvalid, rpc);
    fence_proxy_async();  // the ring's generic writes before the producer's next loads
    consumers_sync();
    if (threadIdx.x == 0) {
      mbar_arrive(&sm.comp_done);
      mbar_arrive(&sm.enc_empty);
    }
    store_tile_loss<Comp::MSE>(sm.bs, sc, (int)(2 * tile), nvalid);
    chain_head<KIND>(P, sm, sc, gates, tile, row0, s, nvalid, ray0, demb, false, nullptr, pp,
                     acc);
    chain(P, maps, sm, sc, gates, tile, row0, pp, acc);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
}

// ------------------------------------------------------------- pass 2: dW

// The wgmma dW job of block blk (of 2 (L - 1) + 1): trunk layer i = 1 +
// blk / 2, output rows 128 (blk & 1).. of dW_i[:, :HID] = d_pre_i^T h_{i-1};
// the last block the dir layer's Wdir[:, :HID] = d_hdir_pre^T h_{L-1}.
struct Dw90Job {
  int layer;    // the layer whose d_pre is A (L: the dir layer, A = ddir)
  int out0;     // the first output row
  float* c;     // where its rows go in the packed gradients
  int ldc;
};

__host__ __device__ inline Dw90Job dw90_job(const FieldArgs& P, float* gmats, int blk) {
  const int L = P.num_layers;
  if (blk == 2 * (L - 1)) return {L, 0, gmats + P.wdir_off, HID + P.kd};
  const int i = 1 + blk / 2;
  const int ldc = ((P.skip_mask >> i) & 1) ? HID + P.kx : HID;
  return {i, DW90_ROWS * (blk & 1), gmats + P.w_off[i] + (long long)DW90_ROWS * (blk & 1) * ldc,
          ldc};
}

// One CTA: block blockIdx.x over the rows of partition blockIdx.y of the
// pass's `rows` (stash layer stride rows_s); its partial sum goes to
// dwpart.  Warpgroup g owns output rows 64 g.. (A's box g); thread
// CONSUMERS streams the slabs.
__global__ void __launch_bounds__(DW90_THREADS, 1)
dw90_kernel(const __grid_constant__ DwMaps maps, const FieldArgs P, long long rows_s,
            long long rows, float* __restrict__ dwpart) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  SmemDw& sm = *reinterpret_cast<SmemDw*>(smem_raw);
  if (threadIdx.x == 0) {
    if (smem_u32(&sm) & 1023) __trap();
    for (int s = 0; s < DW90_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Dw90Job jb = dw90_job(P, nullptr, blockIdx.x);
  const bool dir = jb.layer == P.num_layers;
  const long long per = (rows + gridDim.y * 64LL - 1) / (gridDim.y * 64LL) * 64;
  const long long r_begin = blockIdx.y * per;
  const long long r_end = r_begin + per < rows ? r_begin + per : rows;
  const int n_slabs = r_end > r_begin ? (int)((r_end - r_begin) / 64) : 0;

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* am = dir ? &maps.ddir : &maps.dpre;
      const long long a_row = dir ? 0 : jb.layer * rows_s;
      const long long b_row = (jb.layer - 1) * rows_s;
      int st = 0, ph = 0;
      for (int i = 0; i < n_slabs; ++i) {
        const long long r = r_begin + 64LL * i;
        mbar_wait(&sm.empty[st], ph ^ 1);
        const uint32_t full = smem_u32(&sm.full[st]);
        mbar_expect_tx(full, DW90_A + DW90_B);
        for (int q = 0; q < 2; ++q)
          tma_load_at(smem_u32(sm.a[st]) + q * 8192, am, jb.out0 + 64 * q, (int)(a_row + r), full);
        for (int q = 0; q < 4; ++q)
          tma_load_at(smem_u32(sm.b[st]) + q * 8192, &maps.h, 64 * q, (int)(b_row + r), full);
        if (++st == DW90_STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  const int g = threadIdx.x >> 7;
  float acc[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = 0.f;
  int st = 0, ph = 0, prev = -1;
  for (int i = 0; i < n_slabs; ++i) {
    mbar_wait(&sm.full[st], ph);
    __syncwarp();
    const uint64_t da = make_desc_mn(smem_u32(sm.a[st]) + g * 8192);
    const uint64_t db = make_desc_mn(smem_u32(sm.b[st]));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_n256_tt(acc, da + 128 * k, db + 128 * k);  // 16 rows: 2 KB
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[prev]);
    }
    prev = st;
    if (++st == DW90_STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  const int r0 = 64 * g + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  float* out = dwpart + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * DW90_ROWS * HID;
#pragma unroll
  for (int j = 0; j < HID / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (r0 + 8 * h) * HID + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// gmats += the sum of the partitions' partial blocks, in partition order.
__global__ void dw90_reduce(const FieldArgs P, float* gmats, const float* __restrict__ dwpart,
                            int blocks, int parts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)blocks * DW90_ROWS * HID) return;
  const int blk = (int)(idx / (DW90_ROWS * HID));
  const int e = (int)(idx - (long long)blk * DW90_ROWS * HID);
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += dwpart[((long long)p * blocks + blk) * DW90_ROWS * HID + e];
  const Dw90Job jb = dw90_job(P, gmats, blk);
  jb.c[(long long)(e / HID) * jb.ldc + e % HID] += s;
}

// gvecs[j] += the sum over the slots of part[slot * nv + j] (the last
// column: *loss), each of the 8 warps summing every 8th slot in order, then
// the warps in order.
__global__ void __launch_bounds__(256)
reduce_slots(const float* __restrict__ part, int slots, int nv, int n_vecs, float* gvecs,
             float* loss) {
  __shared__ float ws[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < nv)
    for (int t = w; t < slots; t += 8) s += part[(long long)t * nv + j];
  ws[w][lane] = s;
  __syncthreads();
  if (w == 0 && j < nv) {
    float a = 0.f;
    for (int k = 0; k < 8; ++k) a += ws[k][lane];
    if (j < n_vecs) gvecs[j] += a;
    else if (loss != nullptr) *loss += a;
  }
}

// ------------------------------------------------------------------ host

// What the kernels on this tile set up: the layout records, the shape checks
// (the backward kernels' widths, and at least one sample a tile row), the
// scratch of one pass and the pass sizes, for R rays of s_tile samples in a
// tile's rows (K3, K7: S; K4, K6: Sf; K9: max(Sc, Sf), two row sets a tile,
// vt = 2), or R rows of 128 a tile (rows: K8, s_tile unread).
struct Bwd90Call {
  FieldArgs P;
  BwdWeights W;
  Scratch90 sc;
  int rpc, tiles_pass, vt;
  bool rows;
  long long tiles_total;
};

inline int bwd90_setup(const long long* meta, long long n_meta, const void* mats,
                       const float* vecs, long long E, const void* mats_t, const long long* meta_t,
                       long long n_meta_t, long long R, long long s_tile, void* scratch,
                       long long scratch_bytes, long long n_vecs, Bwd90Call* c,
                       bool rows = false, int vt = 1) {
  int err = parse_meta(meta, n_meta, mats, vecs, E, &c->P);
  if (err) return err;
  err = parse_meta_t(meta_t, n_meta_t, c->P, mats_t, &c->W);
  if (err) return err;
  // the trunk layers' transposed blocks lie one after the other
  // (transposed_mats): one tensor map reads them all
  for (int i = 2; i < c->P.num_layers; ++i)
    if (c->W.wt_off[i] != c->W.wt_off[1] + (long long)(i - 1) * HID * HID) return ERR_META;
  if (c->P.emb_dim % 8 || 2 * c->P.num_layers + 4 > MAX_JOBS || n_vecs < 1 ||
      (!rows && (s_tile < 1 || s_tile > TILE_M)) || R < 0)
    return ERR_SHAPE;
  c->vt = vt;
  c->rows = rows;
  c->rpc = rows ? ROWS : rays_per_tile(s_tile);
  c->tiles_total = (R + c->rpc - 1) / c->rpc;
  const long long cap = MAX_TILES_PER_PASS / vt;
  c->tiles_pass = (int)(c->tiles_total < cap ? c->tiles_total : cap);
  if (carve90(static_cast<char*>(scratch), c->P, (long long)vt * c->tiles_pass, (int)n_vecs,
              &c->sc, vt) > scratch_bytes)
    return ERR_SHAPE;
  return 0;
}

// Passes 2 and 3 for the nt tiles of one pass: the wgmma dW blocks, the
// narrow jobs on dw_kernel, the row sums (2 slots a tile).
inline int finish90(const Bwd90Call& c, const DwMaps& dm, int nt, int n_sm, float* gmats,
                    float* gvecs, float* loss, int n_vecs, cudaStream_t stream) {
  const FieldArgs& P = c.P;
  const Scratch& sc = c.sc.s;
  const long long rows = (long long)nt * TILE_M;
  const int blocks = c.sc.blocks;
  int parts = n_sm / blocks;
  parts = parts < 1 ? 1 : (parts > DW90_PARTS ? DW90_PARTS : parts);
  dw90_kernel<<<dim3(blocks, parts), DW90_THREADS, DW90_SMEM_BYTES, stream>>>(
      dm, P, sc.rows, rows, c.sc.dwpart90);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n90 = (long long)blocks * DW90_ROWS * HID;
  dw90_reduce<<<(unsigned)((n90 + 255) / 256), 256, 0, stream>>>(P, gmats, c.sc.dwpart90,
                                                                   blocks, parts);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  DwJobs J;
  J.n = 0;
  J.rows = rows;
  const long long ls = sc.rows * HID;
  const int L = P.num_layers, kx = P.kx, kd = P.kd, E = P.emb_dim;
  int n = 0;
  add_job(J, n, sc.dpre, HID, HID, HID, sc.encx, kx, kx, gmats + P.w_off[0], kx);
  for (int i = 1; i < L; ++i)
    if ((P.skip_mask >> i) & 1)
      add_job(J, n, sc.dpre + i * ls, HID, HID, HID, sc.encx, kx, kx, gmats + P.w_off[i] + HID,
              HID + kx);
  add_job(J, n, sc.ddir, HALF, HALF, HALF, sc.encd, kd, kd, gmats + P.wdir_off + HID, HID + kd);
  add_job(J, n, sc.dapp, HALF, HALF, HALF, sc.embr, E, E, gmats + P.wapp_off, E);
  add_job(J, n, sc.drgb, DRGB_LD, DRGB_LD, 3, sc.happ, HALF, HALF, gmats + P.wrgb_off, HALF);
  if (n != sc.dw_tiles) return ERR_META;
  dw_kernel<NARROW_PARTS><<<dim3(n, NARROW_PARTS), DW_THREADS, 0, stream>>>(J, sc.dwpart, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long n_el = (long long)n * DW_TILE * DW_TILE;
  dw_reduce<NARROW_PARTS><<<(unsigned)((n_el + 255) / 256), 256, 0, stream>>>(J, sc.dwpart, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_slots<<<(sc.nv + 31) / 32, 256, 0, stream>>>(sc.part, 2 * nt, sc.nv, n_vecs, gvecs,
                                                        loss);
  return (int)cudaGetLastError();
}

// Run the passes of a kernel on this tile: the tensor maps (K8's three for
// rows), then for each slice of at most tiles_pass tiles, clear its row
// sums, launch(grid, maps, rays) the tile kernel (`kernel`) on a persistent
// grid, then passes 2 and 3 over the slice's vt x nt tiles of rows.
template <class Kernel, class Launch>
inline int run_passes90(const Bwd90Call& c, Kernel kernel, BwdRays rays, float* gmats,
                        float* gvecs, float* loss, int n_vecs, cudaStream_t stream,
                        Launch launch) {
  const FieldArgs& P = c.P;
  const Scratch& sc = c.sc.s;
  const int L = P.num_layers;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  BwdMaps maps{};
  DwMaps dm;
  int err = 0;
  for (int i = 0; i < L && !err; ++i)
    err = weight_map(enc, &maps.w[i], P.mats + P.w_off[i], layer_k(P, i), HID);
  if (!err) err = weight_map(enc, &maps.w[L], P.mats + P.wdir_off, layer_k(P, L), HALF);
  if (!err && L > 1)
    err = map2d(enc, &maps.wt_trunk, c.W.mats_t + c.W.wt_off[1], HID, (long long)(L - 1) * HID,
                KS, HID);
  if (!err) err = map2d(enc, &maps.wt_dir, c.W.mats_t + c.W.wt_off[L], HALF, HID, KS, HID);
  if (!err) err = map2d(enc, &maps.h, sc.h, HID, L * sc.rows, 64, 64);
  if (!err) err = map2d(enc, &maps.dpre, sc.dpre, HID, L * sc.rows, 64, 64);
  if (!err) err = map2d(enc, &dm.ddir, sc.ddir, HALF, sc.rows, 64, 64);
  if (!err && c.rows) {
    err = weight_map(enc, &maps.wapp, P.mats + P.wapp_off, P.emb_dim, HALF);
    if (!err) err = map2d(enc, &maps.embr, sc.embr, P.emb_dim, sc.rows, KS, ROWS);
    if (!err)
      err = map2d(enc, &maps.wt_app, c.W.mats_t + c.W.wt_off[L + 1], HALF, P.emb_dim, KS, 64);
  }
  if (err) return err;
  dm.h = maps.h;
  dm.dpre = maps.dpre;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)BWD_SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dw90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DW90_SMEM_BYTES);
  int dev = 0, n_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    e = cudaMemsetAsync(sc.part, 0, sizeof(float) * 2 * c.vt * nt * sc.nv, stream);
    if (e != cudaSuccess) return (int)e;
    rays.ray_base = t0 * c.rpc;
    rays.n_tiles = nt;
    int grid = nt < n_sm ? nt : n_sm;
    if (grid > MAX_CTAS) grid = MAX_CTAS;
    launch(grid, maps, rays, nt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int ferr = finish90(c, dm, c.vt * nt, n_sm, gmats, gvecs, loss, n_vecs, stream);
    if (ferr) return ferr;
  }
  return 0;
}

// Run the passes of K3, K4, K6, K7 or K8 on bwd_tile90<Comp>.
template <class Comp>
inline int run_bwd90(const Bwd90Call& c, const Comp& comp, BwdRays rays, float* gmats,
                     float* gvecs, float* loss, float* demb, int n_vecs, cudaStream_t stream) {
  return run_passes90(c, bwd_tile90<Comp>, rays, gmats, gvecs, loss, n_vecs, stream,
                      [&](int grid, const BwdMaps& maps, const BwdRays& r, int) {
                        bwd_tile90<Comp><<<grid, THREADS90, BWD_SMEM_BYTES, stream>>>(
                            maps, c.P, c.sc.s, c.sc.gates, r, comp, demb);
                      });
}

}  // namespace sm90
}  // namespace danerf

// Bytes of scratch K3, K4, K6, K7 or K8 needs for R rays of s samples per
// tile row group (K3, K7: S; K4, K6: Sf), or R rows for s = ROW_TILES (K8);
// negative on a malformed layout or a shape they do not take.
extern "C" long long danerf_bwd_scratch_bytes(const long long* meta, long long n_meta,
                                              long long R, long long s, long long n_vecs) {
  using namespace danerf;
  using namespace danerf::sm90;
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  if (s < 0 || s > TILE_M || R < 0) return ERR_SHAPE;
  const int rpc = s == ROW_TILES ? ROWS : rays_per_tile(s);
  long long tiles = (R + rpc - 1) / rpc;
  if (tiles > MAX_TILES_PER_PASS) tiles = MAX_TILES_PER_PASS;
  Scratch90 sc;
  return carve90(nullptr, P, tiles, (int)n_vecs, &sc);
}

// The dynamic shared memory of a CTA of the tile kernel and of the dW pass
// (ptxas -v reports only static shared memory).
extern "C" long long danerf_bwd_tile_smem_bytes() { return (long long)danerf::sm90::BWD_SMEM_BYTES; }
extern "C" long long danerf_dw90_smem_bytes() { return (long long)danerf::sm90::DW90_SMEM_BYTES; }
