// The forward NeRF-W field in f32 (use_bf16=False) on Hopper's tensor
// cores for the f32 forward kernels, K2 (march_f32.cu), K5 (merged_f32.cu)
// and the per-sample field K1 (mlp_fwd_f32.cu): the counterpart of
// danerf_tpu/kernels/fused_mlp.py _field_from_enc with cdt = float32, as
// _render_kernel, _merged_kernel and _fwd_kernel run it when cfg.use_bf16
// is off.  The argument record, the encoding (encode_cols' values), the
// merge and the composite come from field.cuh; the TMA, mbarrier, wgmma and
// tensor-map helpers from field_sm90.cuh.  field_bwd_f32_sm90.cuh builds
// the f32 K3, K4, K6-K9's tile from these pieces: field_tile and
// load_tiles with stash hooks (NoResStash, NoEncStash here; the backward's
// also gives field_tile its relu gates), stream_tile, mma_slices.  Two row
// layouts (sm90::Kind): RAYS, a tile of rpc rays of s samples (K2-K7, K9),
// and ROW_TILE, 128 independent rows (K1, K8), each its own point encoded
// at z = 0 (y = 2^i x, field_f32.cuh RowEnc's values) with its own
// appearance term.
//
// Numerics: 3xTF32.  Encodings, activations, the appearance term and the
// heads stay f32.  Every trunk and dir-layer product a.b is formed on the
// tensor cores from the split operands, a = a_hi + a_lo with a_hi =
// rna_tf32(a), a_lo = rna_tf32(a - a_hi) (|a - a_hi - a_lo| <= 2^-22 |a|),
// as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms first, in the f32
// accumulator; the dropped a_lo.b_lo is of f32 rounding's order.  The
// weights are split once on the host (fused_mlp.split_tf32,
// PackedParams.mats_tf32), each activation in registers.  bias + relu,
// the density head (an f32 sum of h . wd over the trunk's last output),
// happ = (relu(hdir_pre) + emb@Wapp) + bapp and rgb = sigmoid(happ@Wrgb +
// brgb) run in f32 in the JAX order; the appearance term emb@Wapp^T is an
// f32 FMA chain over k in order, once a ray by the encoders (RAYS) or once
// a row by the consumers in the dir layer's epilogue (ROW_TILE: row_app4).
// Only the summation order differs from the plain version's.
//
// Bound on an H100: operations.  The field is 527,872 MACs a sample
// (534,528 with time); 3xTF32 runs three tensor-core products for each, so
// K2's 65,536-ray x 64-sample chunk is 3 x 4.43 TFLOP, 26.9 ms at TF32's
// 494.7 TFLOP/s (FFMA's bound, 66.1 ms at FP32's 67, is what the f32 tile
// before this one could not beat).  The weight stream is the second bound:
// a 128-row tile reads every weight's hi and lo (4.2 MB) from L2, ~138 GB a
// chunk.
//
// Design: field_sm90.cuh's tile in f32.  A persistent CTA per SM walks
// over tiles of 128 (ray, sample) rows with 3 warpgroups.
// - Warpgroup 2 produces (setmaxnreg 80; the consumers take 208).  Its
//   first thread streams the split weights through a ring of NST stages; a
//   stage is an 8-deep K slice of one layer's whole N, hi then lo (256 x 8 x
//   2 f32 = 16 KB; 8 KB for the dir layer), one TMA box over (K, N, {hi,
//   lo}) in the 32-byte-swizzled K-major rows wgmma's tf32 B operand
//   takes; full/empty mbarriers pace it; the tensor maps are encoded per
//   launch, as field_sm90.cuh's.  Its warps 1-3 load each tile's rays and
//   depths into one of two buffers and form the tile's appearance term.
// - Warps 0-7 are two consumer warpgroups; warpgroup g owns rows
//   64g..64g+63 and each layer's whole N: wgmma.mma_async m64n256k8
//   (m64n128k8 for the dir layer) .tf32 with A from registers and B from
//   the stage, 128 f32 accumulators a thread.  Each thread loads its m64k8
//   fragment (rows ra, ra + 8, columns t, t + 4 of a k8 step) from the
//   activations in shared memory, or computes it from the tile's rays where
//   the layer reads an encoding (encode_cols' arithmetic, the same values),
//   and splits it; two fragment sets alternate, so a slice's loads overlap
//   the products of the slice before.  A warp reads and writes only its own
//   16 rows, so a layer's output overwrites its input (one 128 KB buffer)
//   behind nothing but the wait for its products.  The density and rgb
//   heads are reduced from the accumulators (a quad of lanes holds a row).
//   Then one warp a ray composites (K5 merges first).
// Shared memory: ring 80 KB (five stages), activations 128 KB, the tile's
// depths and rays twice, the appearance term 4 KB, rgb and sigma 2 KB:
// 220,736 of the 232,448 bytes a block may use.  K5's merge arrays live in
// the activation buffer between tiles.  A row tile's points, directions and
// times (3.5 KB) take the rays' two buffers and the appearance term's place
// (tile_rows), one buffer: the backward releases it after its composite, so
// the next tile's rows load behind the transposed chain.
//
// Layout of the f32 activations: 16-column blocks of 128 rows, element
// (row, col) at ((col >> 4) * 128 + row) * 16 + ((col & 15) ^ (((row >> 1)
// & 3) << 2)), so a warp's fragment loads (8 rows x 4 columns) and its
// epilogue stores hit distinct banks.

#pragma once

#include <cuda.h>
#include <cstddef>

#include "field_sm90.cuh"

namespace danerf {
namespace tf32 {

using sm90::CONSUMERS;
using sm90::ENC0;
using sm90::ENCODERS;
using sm90::RAYS;
using sm90::ROW_TILE;
using sm90::Rays;
using sm90::layer_k;
using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::mbar_wait_at;
using sm90::my_tiles;
using sm90::smem_u32;

constexpr int ROWS = TILE_M;                // 128 rows a tile
constexpr int THREADS = CONSUMERS + 128;    // + the producer warpgroup
constexpr int NST = 5;                      // ring stages
constexpr int KS = 8;                       // K slice of a stage: one k8 step
constexpr int ROW_BYTES = KS * 4;           // a stage row: 32 bytes, 32-byte swizzle
constexpr int STAGE_BYTES = 2 * HID * ROW_BYTES;  // hi and lo of N = 256: 16 KB
constexpr int ACC = HID / 2;                // f32 accumulators a thread (m64n256)

struct TileRays {                           // one tile's rows and rays
  float z[ROWS];
  float o[MAX_RPC * 3], d[MAX_RPC * 3];
  float t[MAX_RPC];
};

// A row tile's inputs (ROW_TILE): each row's point, direction and time
// (zeros past the launch's rows) and how many of its rows are valid.
struct TileRows {
  float x[ROWS * 3], d[ROWS * 3];
  float t[ROWS];
  int n;
};

struct Smem32 {
  unsigned char ring[NST][STAGE_BYTES];     // first: 1024-aligned (init32 checks)
  float act[HID * ROWS];                    // trunk activations; K5's merge arrays between tiles
  TileRays tr[2];                           // tile c in tr[c & 1]; a row tile's inputs here
  float app[MAX_RPC * HALF];                // the tile's per-ray emb @ Wapp^T; ... and here
  float rgb[ROWS * 3];
  float sigma[ROWS];
  unsigned long long full[NST], empty[NST];
  unsigned long long tr_full[2], tr_empty[2], app_full, app_empty;
};
constexpr size_t SMEM_BYTES = sizeof(Smem32);
static_assert(SMEM_BYTES <= 232448, "the f32 Hopper tile exceeds the 227 KB a block may use");
static_assert(MERGE_MAX <= sizeof(Smem32::act), "the merge arrays must fit in sm.act");
static_assert(offsetof(Smem32, app) == offsetof(Smem32, tr) + sizeof(Smem32::tr) &&
                  sizeof(TileRows) <= sizeof(Smem32::tr) + sizeof(Smem32::app) &&
                  offsetof(Smem32, tr) % 16 == 0,
              "a row tile's inputs must fit in the rays' buffers and the appearance term");

// Tile c's input buffer and the parity of its use: rays alternate between
// two (tr[c & 1]), rows have one (tile_rows, on barrier 0).
template <int KIND>
__device__ __forceinline__ int in_buf(int c) {
  return KIND == ROW_TILE ? 0 : c & 1;
}
template <int KIND>
__device__ __forceinline__ int in_phase(int c) {
  return KIND == ROW_TILE ? c & 1 : (c >> 1) & 1;
}

// One tensor map a layer (the trunk's, then the dir layer's) over the split
// weights: dims (K, N, {hi, lo}), boxes of 8 K x N x 2.
struct __align__(64) SplitMaps {
  CUtensorMap m[MAX_LAYERS + 1];
};

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

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ Smem32& smem32() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return *reinterpret_cast<Smem32*>(smem_raw);
}

// A row tile's inputs, over the rays' buffers and the appearance term,
// which a row tile does not use.
__device__ __forceinline__ TileRows& tile_rows(Smem32& sm) {
  return *reinterpret_cast<TileRows*>(sm.tr);
}
__device__ __forceinline__ const TileRows& tile_rows(const Smem32& sm) {
  return *reinterpret_cast<const TileRows*>(sm.tr);
}

// The box at (c0, 0, 0) of a 3-d `map` into shared memory at dst, its bytes
// counted on the barrier at bar.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(0), "r"(0), "r"(bar)
      : "memory");
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (cvt.rna: nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// Offset of (row, col) in the activation buffer.
__device__ __forceinline__ int off32(int row, int col) {
  return ((col >> 4) * ROWS + row) * 16 + ((col & 15) ^ (((row >> 1) & 3) << 2));
}

// Pin the accumulators after a wait: no read of them moves above it.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DANERF_T32_ACC8(b)                                                               \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),        \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x N f32 of the warpgroup) (+)= A (64 x 8, tf32 fragments in
// registers) B^T (N x 8, tf32 K-major in shared memory); scale_d = 0
// overwrites.  N = 256 uses d[0..127], N = 128 d[0..63].
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  if constexpr (N == 256) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : DANERF_T32_ACC8(0), DANERF_T32_ACC8(8), DANERF_T32_ACC8(16), DANERF_T32_ACC8(24),
          DANERF_T32_ACC8(32), DANERF_T32_ACC8(40), DANERF_T32_ACC8(48), DANERF_T32_ACC8(56),
          DANERF_T32_ACC8(64), DANERF_T32_ACC8(72), DANERF_T32_ACC8(80), DANERF_T32_ACC8(88),
          DANERF_T32_ACC8(96), DANERF_T32_ACC8(104), DANERF_T32_ACC8(112), DANERF_T32_ACC8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 128, "the tile's wgmma widths are 256 and 128");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : DANERF_T32_ACC8(0), DANERF_T32_ACC8(8), DANERF_T32_ACC8(16), DANERF_T32_ACC8(24),
          DANERF_T32_ACC8(32), DANERF_T32_ACC8(40), DANERF_T32_ACC8(48), DANERF_T32_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

#undef DANERF_T32_ACC8

// ---------------------------------------------------------------- encodings

// The value encode_cols (field.cuh) writes at column col of the position
// (+ time) encoding of a valid row of origin o, direction d, depth z and
// time t: the same arithmetic, so the same bits.
__device__ __forceinline__ float enc_x_at(const FieldArgs& P, int col, const float* o,
                                          const float* d, float z, float t) {
  const float half_pi = 1.57079637f;
  const int nx = 3 * (1 + 2 * P.pos_levels);
  if (col < nx) {
    const int c = col < 3 ? 0 : col - 3, lvl = c / 6, r = c - 6 * lvl;
    const int k = col < 3 ? col : (r < 3 ? r : r - 3);
    const float f = (float)(1 << lvl);
    const float y = __fadd_rn(o[k] * f, __fmul_rn(z, d[k] * f));
    if (col < 3) return y;
    return sinf(r < 3 ? y : __fadd_rn(y, half_pi));
  }
  const int c = col - nx;
  if (c >= P.nt) return 0.f;
  if (c == 0) return t;
  const float y = t * (float)(1 << ((c - 1) >> 1));
  return sinf(((c - 1) & 1) ? __fadd_rn(y, half_pi) : y);
}

// The same for the direction encoding (y = 2^l d).
__device__ __forceinline__ float enc_d_at(const FieldArgs& P, int col, const float* d) {
  const float half_pi = 1.57079637f;
  if (col >= 3 * (1 + 2 * P.dir_levels)) return 0.f;
  const int c = col < 3 ? 0 : col - 3, lvl = c / 6, r = c - 6 * lvl;
  const int k = col < 3 ? col : (r < 3 ? r : r - 3);
  const float f = (float)(1 << lvl);
  const float y = __fadd_rn(d[k] * f, __fmul_rn(0.f, 0.f * f));
  if (col < 3) return y;
  return sinf(r < 3 ? y : __fadd_rn(y, half_pi));
}

// The thread's two rows of a tile (row0, row0 + 8): each one's ray in the
// tile's buffer, depth and time, and whether it holds a sample (rows past
// the tile's rays are zero).
struct RowIn {
  int ray[2];
  float z[2], t[2];
  bool valid[2];
};

__device__ __forceinline__ RowIn row_inputs(const TileRays& tr, int row0, int s, int rpc) {
  RowIn in;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h, j = row / s;
    in.valid[h] = j < rpc;
    in.ray[h] = in.valid[h] ? j : 0;
    in.z[h] = tr.z[in.valid[h] ? row : 0];
    in.t[h] = tr.t[in.ray[h]];
  }
  return in;
}

// The same for a row tile: each row is its own "ray" (its point and
// direction at index row) at z = 0, valid below the tile's rows (the rest
// encode as zeros, as field_f32.cuh RowEnc's do).
__device__ __forceinline__ RowIn row_inputs(const TileRows& rw, int row0) {
  RowIn in;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    in.valid[h] = row < rw.n;
    in.ray[h] = row;
    in.z[h] = 0.f;
    in.t[h] = rw.t[row];
  }
  return in;
}

// ------------------------------------------------------------------ setup

// Barriers: full[s] completes when the producer's load lands, empty[s] when
// both consumer warpgroups are done with the stage; tr_full[b] when the
// encoders have loaded a tile's rays into buffer b, tr_empty[b] when the
// consumers have composited it; app_full when the encoders have formed a
// tile's appearance term, app_empty when the consumers have read it.
__device__ __forceinline__ void init32(Smem32& sm) {
  if (threadIdx.x == 0) {
    if (smem_u32(&sm) & 1023) __trap();  // the swizzle patterns need aligned stages
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.tr_full[b], 1);
      mbar_init(&sm.tr_empty[b], 1);
    }
    mbar_init(&sm.app_full, 1);
    mbar_init(&sm.app_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The weight stream (the first thread of the producer warpgroup): every
// tile of this CTA streams every layer's K slices, hi and lo, in the order
// the consumers take them (stream_tile: one tile's).
__device__ __forceinline__ void stream_tile(const SplitMaps& maps, const FieldArgs& P, Pipe& pp) {
  const uint32_t ring = smem_u32(&smem32());
  const uint32_t full = ring + offsetof(Smem32, full), empty = ring + offsetof(Smem32, empty);
  for (int i = 0; i <= P.num_layers; ++i) {
    const int K = layer_k(P, i), n = i == P.num_layers ? HALF : HID;
    for (int k0 = 0; k0 < K; k0 += KS) {
      mbar_wait_at(empty + 8 * pp.stage, pp.phase ^ 1);
      mbar_expect_tx(full + 8 * pp.stage, 2 * n * ROW_BYTES);
      tma_load3(ring + pp.stage * STAGE_BYTES, &maps.m[i], k0, full + 8 * pp.stage);
      pp.advance();
    }
  }
}

__device__ __forceinline__ void stream_weights(const SplitMaps& maps, const FieldArgs& P,
                                               long long n_tiles) {
  const int tiles = my_tiles(n_tiles);
  Pipe pp;
  for (int c = 0; c < tiles; ++c) stream_tile(maps, P, pp);
}

// What the encoders do with a tile's rays (or rows) once they are
// published: nothing (K2, K5); field_bwd_f32_sm90.cuh's StashEnc writes the
// tile's encodings and embeddings to the backward's stash.
struct NoEncStash {
  template <class In>
  __device__ __forceinline__ void operator()(const In&, int, long long) const {}
};

// The encoders of a row tile (ROW_TILE): for each tile c of this CTA, once
// the consumers are done with the one buffer, load its 128 rows' points,
// directions and times (zeros past R) and its count of valid rows, publish
// them, then hand them to stash (tile c, its first row).  No appearance
// term: the consumers form each row's.
template <class EncStash>
__device__ __forceinline__ void load_row_tiles(const Rays& rows, const EncStash& stash) {
  Smem32& sm = smem32();
  TileRows& rw = tile_rows(sm);
  const int et = threadIdx.x - ENC0, tiles = my_tiles(rows.n_tiles);
  for (int c = 0; c < tiles; ++c) {
    const long long row0 = (blockIdx.x + (long long)c * gridDim.x) * ROWS;
    mbar_wait(&sm.tr_empty[0], (c & 1) ^ 1);
    for (int i = et; i < 3 * ROWS; i += ENCODERS) {
      const bool ok = row0 + i / 3 < rows.R;
      rw.x[i] = ok ? rows.o[row0 * 3 + i] : 0.f;
      rw.d[i] = ok ? rows.d[row0 * 3 + i] : 0.f;
    }
    for (int i = et; i < ROWS; i += ENCODERS)
      rw.t[i] = (rows.t != nullptr && row0 + i < rows.R) ? rows.t[row0 + i] : 0.f;
    if (et == 0) rw.n = (int)(rows.R - row0 < ROWS ? rows.R - row0 : ROWS);
    sm90::encoders_sync();
    if (et == 0) mbar_arrive(&sm.tr_full[0]);
    stash(rw, c, row0);
  }
}

// The encoders (96 threads): for each tile c of this CTA, once the
// consumers have composited tile c - 2, load its rays (zeros past R) and
// each row's depth (row = ray j * s + sample; zeros past the tile's rays)
// and publish them, then hand them to stash (tile c, its first ray);
// prefetch K5's coarse inputs of the tile into L2; then, once the consumers
// have read the previous tile's appearance term, form this one's in f32 (W:
// the packed f32 weights).
template <class EncStash = NoEncStash>
__device__ __forceinline__ void load_tiles(const FieldArgs& P, const float* __restrict__ W,
                                           const Rays& rays,
                                           const EncStash& stash = EncStash()) {
  Smem32& sm = smem32();
  const int et = threadIdx.x - ENC0;
  const int s = rays.s, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const float* wapp = W + P.wapp_off;
  for (int c = 0; c < tiles; ++c) {
    const long long ray0 = (blockIdx.x + (long long)c * gridDim.x) * rpc;
    TileRays& tr = sm.tr[c & 1];
    mbar_wait(&sm.tr_empty[c & 1], ((c >> 1) & 1) ^ 1);
    for (int idx = et; idx < rpc * 3; idx += ENCODERS) {
      const long long r = ray0 + idx / 3;
      tr.o[idx] = r < rays.R ? rays.o[r * 3 + idx % 3] : 0.f;
      tr.d[idx] = r < rays.R ? rays.d[r * 3 + idx % 3] : 0.f;
    }
    for (int j = et; j < rpc; j += ENCODERS)
      tr.t[j] = (rays.t != nullptr && ray0 + j < rays.R) ? rays.t[ray0 + j] : 0.f;
    for (int row = et; row < ROWS; row += ENCODERS) {
      const int j = row / s;
      const long long r = ray0 + j;
      tr.z[row] = (j < rpc && r < rays.R) ? rays.z[r * s + (row - j * s)] : 0.f;
    }
    sm90::encoders_sync();
    if (et == 0) mbar_arrive(&sm.tr_full[c & 1]);
    stash(tr, c, ray0);
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
          acc = fmaf(rays.emb[r * P.emb_dim + k], __ldg(wapp + n * P.emb_dim + k), acc);
      sm.app[idx] = acc;
    }
    sm90::encoders_sync();
    if (et == 0) mbar_arrive(&sm.app_full);
  }
}

// The producer warpgroup: gives registers up, then its first thread
// streams the weights and its warps 1-3 load the tiles' rays (KIND RAYS:
// K2, K5) or rows (ROW_TILE: K1); the rest of warp 0 is done.
template <int KIND = RAYS>
__device__ __forceinline__ void produce(const SplitMaps& maps, const FieldArgs& P,
                                        const float* W, const Rays& rays) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
  if (threadIdx.x >= ENC0) {
    if constexpr (KIND == ROW_TILE)
      load_row_tiles(rays, NoEncStash());
    else
      load_tiles(P, W, rays);
  } else if (threadIdx.x == CONSUMERS) {
    stream_weights(maps, P, rays.n_tiles);
  }
}

// The consumers take the registers the producer warpgroup gives up: 128 x
// 80 + 256 x 208 <= 384 x 168, the launch's allocation.
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
}

// ------------------------------------------------------------- tile stages

// A k8 step's A fragment for the thread, split.
struct AFrag {
  uint32_t hi[4], lo[4];
};

// Keep a fragment set in its registers until here: the tensor cores read
// it after its wgmma is issued, until the wait that covers it.
__device__ __forceinline__ void fence_frag(AFrag& f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(f.hi[q]), "+r"(f.lo[q])::"memory");
}

// What slice s of layer i reads: the activations' columns 8s.. (HID / KS
// slices; layer 0 none), then the position (+ time) encoding (layer 0, a
// skip layer) or the direction's (the dir layer).
enum Src { ACT = 0, ENC_X = 1, ENC_D = 2 };

// The thread's values of k8 step k0 of the activations: rows row0 (= 64 g
// + ra) and row0 + 8, columns k0 + t and k0 + t + 4.
__device__ __forceinline__ void act_vals(float (&v)[4], const Smem32& sm, int k0, int row0, int t) {
  const int sw = ((row0 >> 1) & 3) << 2, kb = (k0 >> 4) * ROWS * 16, kin = k0 & 15;
  const float* p0 = sm.act + kb + row0 * 16;
  const float* p1 = p0 + 8 * 16;
  v[0] = p0[(kin + t) ^ sw];
  v[1] = p1[(kin + t) ^ sw];
  v[2] = p0[(kin + t + 4) ^ sw];
  v[3] = p1[(kin + t + 4) ^ sw];
}

__device__ __forceinline__ void split_frag(AFrag& f, const float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(v[q], f.hi[q], f.lo[q]);
}

// The thread's fragment of k8 step k0 of source src (act_vals' rows and
// columns), split; the encodings from the tile's origins (or points) os and
// directions ds, 3 a ray (row) at in.ray.
__device__ __forceinline__ void load_frag(AFrag& f, const Smem32& sm, const float* os,
                                          const float* ds, const RowIn& in, const FieldArgs& P,
                                          int src, int k0, int row0, int t) {
  float v[4];
  if (src == ACT) {
    act_vals(v, sm, k0, row0, t);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q & 1, col = k0 + t + 4 * (q >> 1);
      const float* o = os + 3 * in.ray[h];
      const float* d = ds + 3 * in.ray[h];
      v[q] = !in.valid[h] ? 0.f
             : src == ENC_X ? enc_x_at(P, col, o, d, in.z[h], in.t[h])
                            : enc_d_at(P, col, d);
    }
  }
  split_frag(f, v);
}

// One slice: acc (+)= A_lo B_hi + A_hi B_lo + A_hi B_hi over its k8 step,
// small terms first, one wgmma group; B = the stage at b_hi (hi), hi + N
// rows (lo).
template <int N>
__device__ __forceinline__ void mma_slice(float (&acc)[ACC], const AFrag& f, uint32_t b_hi,
                                          bool first) {
  const uint64_t dh = make_desc(b_hi, ROW_BYTES), dl = make_desc(b_hi + N * ROW_BYTES, ROW_BYTES);
  sm90::wgmma_fence();
  wgmma_tf32<N>(acc, f.lo, dh, !first);
  wgmma_tf32<N>(acc, f.hi, dl, 1);
  wgmma_tf32<N>(acc, f.hi, dh, 1);
  sm90::wgmma_commit();
}

// Both consumer warpgroups release stage `stage` (one thread each).
__device__ __forceinline__ void release(Smem32& sm, int stage) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
}

// acc = A @ B^T over n_slices K slices of the ring for the calling
// warpgroup's 64 rows, frag(f, s) loading slice s's A fragment.  Two
// fragment sets alternate, so a slice's loads and splits overlap the slice
// before's products; each stage is released as soon as its products are
// done.  The tensor cores read a set's registers until the wait that
// retires its products, which the compiler does not know: a set must stay
// in registers of its own.  One loop body picks a set by s & 1 (the
// forward's: its two branches load different sources, and the SASS keeps
// two sets, which chip_smoke.py's build phase checks); where both
// branches would load the same way, the compiler hoists the two loads
// into one register set, which the next slice's loads overwrite under the
// products still reading it (the transposed chain's, wrong run to run on
// the H100), so X2 loads, uses and fences each set in straight-line code
// of its own half of a loop unrolled twice.  (The forward on X2 read 4-6%
// slower in the f32 K2.)
template <int N, bool X2 = false, class Frag>
__device__ __forceinline__ void mma_slices(float (&acc)[ACC], Smem32& sm, int n_slices, Pipe& pp,
                                           Frag frag) {
  AFrag f0, f1;
  int prev = -1;
  auto slice = [&](AFrag& f, AFrag& other, int s) {
    const uint32_t b = smem_u32(sm.ring[pp.stage]);
    frag(f, s);
    mbar_wait(&sm.full[pp.stage], pp.phase);
    mma_slice<N>(acc, f, b, s == 0);
    if (prev >= 0) {
      sm90::wgmma_wait<1>();  // the slice before is done: its stage and fragment set are free
      fence_frag(other);
      release(sm, prev);
    }
    prev = pp.stage;
    pp.advance();
  };
  if constexpr (X2) {
    for (int s = 0; s < n_slices; s += 2) {
      slice(f0, f1, s);
      if (s + 1 < n_slices) slice(f1, f0, s + 1);
    }
  } else {
    for (int s = 0; s < n_slices; ++s) {
      const uint32_t b = smem_u32(sm.ring[pp.stage]);
      if (s & 1) {
        frag(f1, s);
        mbar_wait(&sm.full[pp.stage], pp.phase);
        mma_slice<N>(acc, f1, b, false);
      } else {
        frag(f0, s);
        mbar_wait(&sm.full[pp.stage], pp.phase);
        mma_slice<N>(acc, f0, b, s == 0);
      }
      if (prev >= 0) {
        sm90::wgmma_wait<1>();  // the slice before is done: its stage and fragment set are free
        if (s & 1)
          fence_frag(f0);
        else
          fence_frag(f1);
        release(sm, prev);
      }
      prev = pp.stage;
      pp.advance();
    }
  }
  sm90::wgmma_wait<0>();
  fence_frag(f0);
  fence_frag(f1);
  fence_acc(acc);
  release(sm, prev);
}

// acc = A @ W_i^T over layer i's K slices (N = 256 trunk, 128 dir): A the
// activations, then the layer's encoding (of os, ds: load_frag's).
template <int N>
__device__ __forceinline__ void mma_layer(float (&acc)[ACC], Smem32& sm, const float* os,
                                          const float* ds, const RowIn& in, const FieldArgs& P,
                                          int i, Pipe& pp) {
  const int hs = HID / KS;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int enc = i == P.num_layers ? ENC_D : ENC_X;
  mma_slices<N>(acc, sm, layer_k(P, i) / KS, pp, [&](AFrag& f, int s) {
    const bool act = i > 0 && s < hs;
    load_frag(f, sm, os, ds, in, P, act ? ACT : enc, KS * (act || i == 0 ? s : s - hs), row0,
              t);
  });
}

// What the forward keeps for a backward pass, and the relu gates it takes:
// nothing, and each value's own sign (K2, K5); field_bwd_f32_sm90.cuh's
// StashRes keeps each trunk layer's output, sigma_pre and happ, and takes
// the gates of an f32 evaluation on the CUDA cores.  begin: before layer
// i's products (i = L: the dir layer's); relu / relu_dir: the outputs of
// pre-activations x0, x1 at the thread's row row0 + 8 h, columns 8 j + 2 t
// and + 1; relu_sigma: sigma of sigma_pre v at row0 + 8 h under relu;
// trunk: layer i's outputs at those places; sigma_pre: row's (lanes t = 0);
// dir: relu(hdir_pre) and happ at the same places (j < 16).
struct NoResStash {
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ float2 relu(int, int, float x0, float x1) const {
    return make_float2(fmaxf(x0, 0.f), fmaxf(x1, 0.f));
  }
  __device__ __forceinline__ float2 relu_dir(int h, int j, float x0, float x1) const {
    return relu(h, j, x0, x1);
  }
  __device__ __forceinline__ float relu_sigma(int, float v) const { return fmaxf(v, 0.f); }
  __device__ __forceinline__ void trunk(int, int, int, float, float) {}
  __device__ __forceinline__ void sigma_pre(int, float) {}
  __device__ __forceinline__ void dir(int, int, float, float, float, float) {}
};

// The appearance term of the thread's two rows of a row tile (rows row0,
// row0 + 8: in.valid; zero past the tile's rows) at the columns of its
// fragment's j = j0..j0 + 3 (8 j + 2 t and + 1), a[jj][h][e]: emb @
// Wapp^T, each an f32 FMA chain over k in order (the sums load_tiles forms
// for a ray's and the gate pass's field_block for a row's).  emb0: the
// embedding of the tile's first row (E a row, E % 4 == 0, 16-byte
// aligned); W: the packed f32 weights, Wapp (HALF, E).
__device__ __forceinline__ void row_app4(float (&a)[4][2][2], const FieldArgs& P,
                                         const float* __restrict__ W,
                                         const float* __restrict__ emb0, const RowIn& in,
                                         int row0, int j0, int t) {
  const int E = P.emb_dim;
  const float* wapp = W + P.wapp_off + (long long)(8 * j0 + 2 * t) * E;
  const float* e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) e[h] = emb0 + (long long)(in.valid[h] ? row0 + 8 * h : 0) * E;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) a[jj][h][0] = a[jj][h][1] = 0.f;
  for (int k = 0; k < E; k += 4) {
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(e[0] + k));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(e[1] + k));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wapp + (8 * jj + q) * E + k));
        float& a0 = a[jj][0][q];
        float& a1 = a[jj][1][q];
        a0 = fmaf(x0.x, w.x, a0); a0 = fmaf(x0.y, w.y, a0);
        a0 = fmaf(x0.z, w.z, a0); a0 = fmaf(x0.w, w.w, a0);
        a1 = fmaf(x1.x, w.x, a1); a1 = fmaf(x1.y, w.y, a1);
        a1 = fmaf(x1.z, w.z, a1); a1 = fmaf(x1.w, w.w, a1);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!in.valid[h]) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) a[jj][h][0] = a[jj][h][1] = 0.f;
    }
  }
}

// The field on tile c (the c-th of this CTA) for the calling consumer
// warpgroup's rows, once the encoders have loaded its rays (KIND RAYS) or
// rows (ROW_TILE): the trunk layers in place in sm.act, sigma from the last
// one's accumulators, the dir layer and the rgb head from its
// accumulators.  Leaves sm.rgb (128 x 3) and sm.sigma (128) valid, and the
// tile's appearance term released, behind a consumers' barrier; the last
// trunk layer's output stays in sm.act.  s = samples per ray in the tile's
// rows; stash keeps the residuals a backward pass needs and gives the relu
// gates; emb0 (ROW_TILE): the embedding of the tile's first row, for each
// row's appearance term (row_app4).
template <int KIND = RAYS, class Stash = NoResStash>
__device__ __forceinline__ void field_tile(const FieldArgs& P, const float* __restrict__ W,
                                           Smem32& sm, int c, int s, int rpc, Pipe& pp,
                                           float (&acc)[ACC], Stash&& stash = Stash(),
                                           const float* __restrict__ emb0 = nullptr) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int L = P.num_layers;
  mbar_wait(&sm.tr_full[in_buf<KIND>(c)], in_phase<KIND>(c));
  const float *os, *ds;
  RowIn in;
  if constexpr (KIND == ROW_TILE) {
    const TileRows& rw = tile_rows(sm);
    os = rw.x;
    ds = rw.d;
    in = row_inputs(rw, row0);
  } else {
    const TileRays& tr = sm.tr[c & 1];
    os = tr.o;
    ds = tr.d;
    in = row_inputs(tr, row0, s, rpc);
  }

  for (int i = 0; i < L; ++i) {
    stash.begin(i);
    mma_layer<HID>(acc, sm, os, ds, in, P, i, pp);
    // the warp's own rows: relu(acc + bias) over the layer's input
    const float* bias = P.vecs + P.b_off[i];
    const bool last = i == L - 1;
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < HID / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
      const float2 w = last ? __ldg(reinterpret_cast<const float2*>(P.vecs + P.wd_off + col))
                            : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = stash.relu(h, j, acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
        const float v0 = v.x, v1 = v.y;
        *reinterpret_cast<float2*>(sm.act + off32(row0 + 8 * h, col)) = v;
        stash.trunk(i, h, j, v0, v1);
        dsum[h] = fmaf(v1, w.y, fmaf(v0, w.x, dsum[h]));
      }
    }
    if (last) {
      const float bd = __ldg(P.vecs + P.bd_off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dsum[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += bd;
        if (t == 0) {
          sm.sigma[row0 + 8 * h] = P.softplus ? fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)))
                                              : stash.relu_sigma(h, v);
          stash.sigma_pre(row0 + 8 * h, v);
        }
      }
    }
    __syncwarp();  // the warp's rows are in place before its lanes read them
  }

  // dir branch and rgb head: happ = (relu([h, enc_d] @ Wdir^T + bdir) +
  // emb@Wapp^T) + bapp; rgb = sigmoid(happ @ Wrgb^T + brgb)
  stash.begin(L);
  mma_layer<HALF>(acc, sm, os, ds, in, P, L, pp);
  if constexpr (KIND != ROW_TILE) mbar_wait(&sm.app_full, c & 1);
  {
    const float* bdir = P.vecs + P.bdir_off;
    const float* bapp = P.vecs + P.bapp_off;
    const float* wrgb = W + P.wrgb_off;  // (3, HALF)
    const float* app[2] = {sm.app, sm.app};  // RAYS: the rows' rays' appearance terms
    if constexpr (KIND != ROW_TILE) {
#pragma unroll
      for (int h = 0; h < 2; ++h) app[h] = sm.app + min((row0 + 8 * h) / s, rpc - 1) * HALF;
    }
    float cs[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int j0 = 0; j0 < HALF / 8; j0 += 4) {
      float ra[4][2][2];  // ROW_TILE: the rows' appearance terms at j0..j0 + 3
      if constexpr (KIND == ROW_TILE) row_app4(ra, P, W, emb0, in, row0, j0, t);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj, col = 8 * j + 2 * t;
        const float2 bd2 = __ldg(reinterpret_cast<const float2*>(bdir + col));
        const float2 ba2 = __ldg(reinterpret_cast<const float2*>(bapp + col));
        float2 w[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          w[k] = __ldg(reinterpret_cast<const float2*>(wrgb + k * HALF + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 a = stash.relu_dir(h, j, acc[4 * j + 2 * h] + bd2.x,
                                          acc[4 * j + 2 * h + 1] + bd2.y);
          const float a0 = a.x, a1 = a.y;
          float e0, e1;
          if constexpr (KIND == ROW_TILE) {
            e0 = ra[jj][h][0];
            e1 = ra[jj][h][1];
          } else {
            e0 = app[h][col];
            e1 = app[h][col + 1];
          }
          const float h0 = (a0 + e0) + ba2.x;
          const float h1 = (a1 + e1) + ba2.y;
          stash.dir(h, j, a0, a1, h0, h1);
#pragma unroll
          for (int k = 0; k < 3; ++k) cs[h][k] = fmaf(h1, w[k].y, fmaf(h0, w[k].x, cs[h][k]));
        }
      }
    }
    const float* brgb = P.vecs + P.brgb_off;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = cs[h][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) sm.rgb[(row0 + 8 * h) * 3 + k] = 1.f / (1.f + expf(-(v + __ldg(brgb + k))));
      }
  }
  sm90::consumers_sync();  // every row's rgb and sigma; every read of sm.app
  if (KIND != ROW_TILE && threadIdx.x == 0) mbar_arrive(&sm.app_empty);
}

// The end of tile c for the consumers: once every consumer is done with
// its rays (rows), depths, sm.rgb, sm.sigma and sm.act, hand the input
// buffer back.
template <int KIND = RAYS>
__device__ __forceinline__ void end_tile(Smem32& sm, int c) {
  sm90::consumers_sync();
  if (threadIdx.x == 0) mbar_arrive(&sm.tr_empty[in_buf<KIND>(c)]);
}

// ------------------------------------------------------------------ host

// The tensor map of layer matrix W (rows x K f32, row-major) split into hi
// (at hi) and lo (lo_stride bytes on), read in boxes of 8 K x rows x {hi,
// lo}, 32-byte swizzle.
inline int split_map(sm90::EncodeTiledFn enc, CUtensorMap* m, const float* hi,
                     long long lo_stride, int K, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)lo_stride};
  const cuuint32_t box[3] = {(cuuint32_t)KS, (cuuint32_t)rows, 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(hi), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Host set-up shared by K1, K2 and K5 in f32: the split weights' maps (hi, lo:
// the packed layout twice, lo past hi), the kernel's shared memory limit
// and the persistent grid (one CTA per SM, at most one a tile).
template <class Kernel>
inline int launch_setup(Kernel kernel, const FieldArgs& P, const float* hi, const float* lo,
                        long long n_tiles, SplitMaps* maps, unsigned* grid) {
  const sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const long long stride = (long long)(lo - hi) * 4;
  if (stride <= 0 || stride % 16) return ERR_SHAPE;
  for (int i = 0; i <= P.num_layers; ++i) {
    const bool dir = i == P.num_layers;
    const int err = split_map(enc, &maps->m[i], hi + (dir ? P.wdir_off : P.w_off[i]), stride,
                              layer_k(P, i), dir ? HALF : HID);
    if (err) return err;
  }
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

}  // namespace tf32
}  // namespace danerf
