// The backward of the NeRF-W field in f32 (use_bf16=False) on Hopper's
// tensor cores for K3 (march_bwd_f32.cu) and K7 (march_train_f32.cu), the
// ray march's backward under the caller's cotangents or the MSE, K4
// (merged_train_f32.cu) and K6 (merged_bwd_f32.cu), the merged fine pass's
// under the MSE or the caller's, K8 (mlp_bwd_f32.cu), the per-sample
// field's under each row's cotangents (row tiles, ROW_TILE), and K9
// (hier_onepass_f32.cu), whose own two tile kernels run its coarse and fine
// row sets on these pieces: the counterpart of
// danerf_tpu/kernels/fused_mlp.py _field_bwd_from_res with cdt = float32,
// as _march_bwd_kernel, _train_kernel, _merged_train_kernel,
// _merged_bwd_kernel, _bwd_kernel and _hier_onepass_kernel run it when
// cfg.use_bf16 is off.  It is to field_f32_sm90.cuh what field_bwd_sm90.cuh
// is to field_sm90.cuh; the composites, demb, the narrow dW jobs and the
// row sums' reduction come from bwd_f32_parts.cuh.
//
// Numerics: 3xTF32, as field_f32_sm90.cuh's.  Every trunk, dir-layer,
// transposed-chain and dW product a.b is formed on the tensor cores from
// split operands, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms first,
// in f32 accumulators; nothing is rounded once to TF32 or bf16.  The heads,
// d_pre_rgb, d_sigma_pre, d_happ, the appearance term, demb and the narrow
// dW jobs run in f32 on the CUDA cores.  Every sum runs in a fixed order and
// nothing is added atomically, so two calls give bit-identical results.
// The relu gates (the trunk's, the dir layer's, sigma's under relu) are not
// the tensor-core forward's own: its sums truncate where f32 rounds, so a
// pre-activation near 0 lands on the other side of it from an f32
// evaluation's ~15x more often than two f32 evaluations disagree (59 gates
// against 4 at 1024 x 64 on the H100), and one such gate moves a gradient
// by ~1e-3.  They are those of an f32 forward on the CUDA cores (the gate
// pass, field_f32.cuh's field_block: the FFMA forward's sums),
// so the tile's backward sees the gates an f32 evaluation sees; the forward
// takes them too (a gated output is its tensor-core pre-activation, an
// ungated one 0).
//
// Bound on an H100: operations.  1,552,000 MACs a sample (the forward
// 527,872, the chain and dW 1,024,128), three TF32 products each: 1.23 ms
// for a 1024-ray batch of 64 samples at TF32's 494.7 TFLOP/s (FFMA's bound,
// 3.04 ms at FP32's 67, is what the FFMA tiles before this one could not
// beat).  The stash (~26 KB a row: each trunk output split, hi and lo, and
// each d_pre in f32) is written and read back once, ~1.7 GB at that batch,
// ~0.5 ms at 3.35 TB/s, which the tile and the dW pass must hide.
//
// Gate pass (gate_pass32, before the tile kernel): field_f32.cuh's
// field_block on each tile's rows (two 64-row blocks; the tile kernel's
// tiles: rays through load_rays / RayEnc, a row tile's rows through
// load_rows / RowEnc) with GateStash as its hook, which gathers each relu's
// sign by warp ballots into the words the tile kernel's threads read: a
// record of 4 words a consumer thread a layer, the gates of its accumulator
// fragment (GateRec).  It costs a forward on the CUDA cores (FP32's 67
// TFLOP/s).
//
// Tile kernel (bwd_tile32: a persistent CTA per SM, field_f32_sm90.cuh's 3
// warpgroups and its 5-stage TMA ring of split weights), per tile of 128
// (ray, sample) rows:
// - Forward: field_f32_sm90.cuh's field_tile, the f32 K2's products, with
//   StashRes as its hook: the gate pass's gates, each trunk output split
//   into hi and lo in 8-row groups (the dW pass's B operand, one TMA box a
//   slab), sigma_pre and happ.  The encoders (the producer's warps 1-3)
//   also stash the tile's encodings and each row's embedding (StashEnc).
// - Composite: one warp per ray (bwd_f32_parts.cuh MarchComp32 /
//   MergedComp32) in the ring, which the producer leaves empty until the
//   consumers arrive on comp_done.
// - Chain head (CUDA cores, f32): d_pre_rgb, d_sigma_pre, the heads' row
//   sums; d_happ = d_pre_rgb @ Wrgb and d_hdir_pre on the dir layer's
//   fragments, into sm.act (d_hdir_pre the first product's A) and the stash;
//   each ray's d_happ summed over its rows, demb (a row tile: each row's
//   demb = d_happ @ Wapp).
// - Transposed chain: d_in = d_pre @ W[:, :HID] by 3xTF32 on wgmma
//   m64n256k8, A = d_pre split in registers from sm.act (a warpgroup reads
//   and writes only its own rows), B = W^T (in, out) row-major split on the
//   host (PackedParams.mats_kn_tf32), streamed through the same ring, one
//   3-d box over (out slice, in, {hi, lo}) a stage; gated by the kept masks,
//   written back in place and stashed row-major; its products overlap the
//   next slice's fragment loads, as the forward's do, each fragment set in
//   its own half of a twice-unrolled loop (mma_slices' X2).
// Row sums (the bias gradients): each warp's 16 rows summed in a fixed
// order into its own slot of the tile's SLOTS, which sum_slots32 sums in
// order.  Shared memory: field_f32_sm90.cuh's 220,736 bytes, sigma_pre and
// field_bwd.cuh's BwdSmem: 231,528 of 232,448.
//
// dW pass (dw_t32_kernel): dW = d_pre^T @ input over the stash's rows by
// 3xTF32 on wgmma m64n256k8.  A CTA owns 128 output rows (two consumer
// warpgroups) x 256 input columns of one layer over one fixed partition of
// 1,024 rows (the tensor cores' accumulation truncates: over 8,192-row
// partitions the gradients come out ~2e-4 off f32's at 4,093 rays on the
// H100); a producer thread streams 8-row slabs through an 8-stage ring:
// the input (the stashed split output of the layer before, one 3-d box in
// the weight ring's 32-byte-row format) and d_pre (row-major, four 32 x 8
// boxes, 128-byte swizzle), whose fragments the consumers load and split.
// The partitions are summed in order (dw_t32_reduce).  The jobs of 256
// input columns take it (the trunk layers 1.. and the dir layer's hidden
// block); the narrow ones (encx of layer 0 and the skips, encd, the
// appearance projection, the rgb head) stay on bwd_f32_parts.cuh's FFMA
// dw32_kernel.

#pragma once

#include "field_f32_sm90.cuh"
#include "field_f32.cuh"
#include "bwd_f32_parts.cuh"

namespace danerf {
namespace tf32 {

using f32::CompTile;
using f32::DRGB32;
using f32::Dw32Jobs;
using f32::MAX_TILES_PASS32;
using f32::add_job32;
using sm90::consumers_sync;
using sm90::fence_proxy_async;
using sm90::encoders_sync;

constexpr int SLOTS = CONSUMERS / 32;       // row-sum slots a tile: one a consumer warp
constexpr int DWT_ROWS = 128;               // output rows of a dW CTA
constexpr int DWT_STAGES = 8;
constexpr int DWT_B = 2 * HID * ROW_BYTES;  // a slab of the input: 8 rows x 256, hi and lo
constexpr int DWT_A = DWT_ROWS * ROW_BYTES; // a slab of d_pre: 8 rows x 128 outputs
constexpr int DWT_THREADS = CONSUMERS + 32;
// Rows of a dW partition: the tensor cores' accumulation truncates, so a
// partition's sum stays short (128 slabs, 384 products a thread), and the
// partitions are summed in f32 in order.
constexpr int DWT_PART_ROWS = 1024;

static_assert(CONSUMERS == f32::COMP_THREADS, "the composites run on the consumer warps");

// One pass's stash, rows = tiles * ROWS.
struct ScratchT32 {
  uint32_t* hs;   // L x {hi, lo} x rows / 8 x HID x 8: trunk layer outputs, split, 8-row groups
  float* dpre;    // L x rows x HID: d_pre of each trunk layer
  float* encx;    // rows x kx
  float* encd;    // rows x kd
  float* happ;    // rows x HALF
  float* dapp;    // rows x HALF: d_happ
  float* ddir;    // rows x HALF: d_hdir_pre
  float* drgb;    // rows x DRGB32: d_pre_rgb
  float* embr;    // rows x E: the embedding of the row's ray
  float* part;    // SLOTS a tile x nv: row sums in the vecs layout, + loss
  float* dwpart;  // DW32_PARTS x dw_tiles x 64 x 64: the narrow jobs' partial tiles
  float* dwpart90;  // rows / DWT_PART_ROWS x blocks x DWT_ROWS x HID: the wgmma jobs' partials
  uint4* gates;   // tiles x (L + 1) x CONSUMERS: the gate pass's records (GateRec)
  long long rows;
  int nv, dw_tiles, blocks;
};

struct SmemT32 {  // at the 1024-aligned start of dynamic shared memory
  Smem32 f;                  // the forward's tile; its ring holds the composite's arrays
  float sigma_pre[ROWS];
  BwdSmem bs;                // cotangents, d_pre_rgb, d_sigma_pre, each ray's d_happ sums, loss
  unsigned long long comp_done;
};
constexpr size_t T32_SMEM_BYTES = sizeof(SmemT32);
static_assert(T32_SMEM_BYTES <= 232448, "the f32 backward tile exceeds the 227 KB a block may use");
// The composite's arrays of every shape K3, K4, K6 and K7 take (bwd_smem_bytes /
// merged_smem_bytes <= 232,448 beside field.cuh's SHAPE_TILE_BYTES) fit in
// the ring.
static_assert(232448 - SHAPE_TILE_BYTES - sizeof(BwdSmem) <= sizeof(Smem32::ring),
              "the composite's arrays must fit in the ring");

struct SmemDwT {  // the same
  unsigned char st[DWT_STAGES][DWT_B + DWT_A];  // B (hi, lo), then A
  unsigned long long full[DWT_STAGES], empty[DWT_STAGES];
};
constexpr size_t DWT_SMEM_BYTES = sizeof(SmemDwT);

// The tile's tensor maps: the forward's (field_f32_sm90.cuh), the chain's
// W^T split: every trunk layer's rows of mats_kn as one (HID, rows, {hi,
// lo}) matrix, and the dir layer's first HID rows (HALF, HID, {hi, lo});
// boxes of 8 outputs x 256 inputs x 2.
struct __align__(64) BwdMapsT32 {
  SplitMaps fwd;
  CUtensorMap trunk, dir;
};

// The dW pass's: the split trunk outputs (8, HID rows / 8, 2 L), boxes of
// 8 x 256 x 2; d_pre (HID, L rows) and d_hdir_pre (HALF, rows), boxes of
// 32 x 8.
struct __align__(64) DwMapsT32 {
  CUtensorMap hs, dpre, ddir;
};

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ SmemT32& smem_t32() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return *reinterpret_cast<SmemT32*>(smem_raw);
}

// The box at (c0, c1, c2) of a 3-d `map` into shared memory at dst, its
// bytes counted on the barrier at bar.
__device__ __forceinline__ void tma_load3_at(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                             int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// The products overwrite acc (scale_d = 0 first), but their asm reads it:
// zeroing it where its values are dead ends their live range, so the code
// before the next product keeps no accumulator registers.
__device__ __forceinline__ void dead_acc(float (&acc)[ACC]) {
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = 0.f;
}

struct ConsumerSync {
  __device__ __forceinline__ void operator()() const { consumers_sync(); }
};

// The thread's first row of the tile (64 g + 16 w + lane / 4; the second is
// 8 on), as the accumulator and A fragments lay them.
__device__ __forceinline__ int frag_row() {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}

// The sum over the 8 lanes that share lane & 3 of v[q] (q = 2 jj + e: the
// thread's partial sum of column 8 (j0 + jj) + 2 (lane & 3) + e, jj < 4),
// as a reduce-scatter: three rounds of exchanging half the values, each
// lane keeping its half in a fixed order.  Returns the sum of column
// sum8_col(j0, lane).
__device__ __forceinline__ float sum8(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  float a[4], b[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a[k] = (h4 ? v[4 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, h4 ? v[k] : v[4 + k], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    b[k] = (h3 ? a[2 + k] : a[k]) + __shfl_xor_sync(0xffffffffu, h3 ? a[k] : a[2 + k], 8);
  return (h2 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, h2 ? b[0] : b[1], 4);
}

__device__ __forceinline__ int sum8_col(int j0, int lane) {
  const int q = (lane >> 2) & 7;  // 4 bit4 + 2 bit3 + bit2
  return 8 * (j0 + (q >> 1)) + 2 * (lane & 3) + (q & 1);
}

// ---------------------------------------------------------------- gates

// A gate record (GateRec): for tile c of a pass, layer i (0..L-1 the trunk,
// L the dir layer) and consumer thread tid, the uint4 at gates[(c (L + 1) +
// i) CONSUMERS + tid] holds the relu gates of the thread's accumulator
// fragment: word 2 h + (j >> 4) (h: row row0 + 8 h; j < 32) bit j & 15 the
// gate of column 8 j + 2 t, bit 16 + (j & 15) that of column 8 j + 2 t + 1.
// The dir layer's (j < 16) are in words 0 and 2; bit 0 of its words 1 and 3
// is row0's and row0 + 8's sigma_pre > 0.

// The 4 bits at 0, 8, 16, 24 of x gathered into bits 0..3.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  x &= 0x01010101u;
  x |= x >> 7;
  x |= x >> 14;
  return x & 0xFu;
}

// field_block's stash hook in the gate pass, for 64-row block blk of a tile
// (the rows of consumer warpgroup blk; rec: the tile's records as words).
// A warp owns 8 rows (w8..) and lane l column l + 32 jp of each layer, so
// one ballot a row gives the row's 32 gates of columns 32 jp..; the lane of
// row w8 + (l >> 2), t = l & 3 keeps its row's and takes from it columns 32
// jp + 8 k + 2 t (+ 1), k < 4: its fragment's j = 4 jp + k.  Those are the
// words of tile thread 128 blk + 32 (warp >> 1) + l, at h = warp & 1.
struct GateStash {
  uint32_t* rec;
  int blk, num_layers;
  mutable uint32_t w[2] = {0u, 0u};
  mutable uint32_t mine = 0u;

  __device__ __forceinline__ void take(int jp) const {
    const uint32_t x = mine >> (2 * (threadIdx.x & 3));
    const uint32_t v = (nibble(x) | (nibble(x >> 1) << 16)) << (4 * (jp & 3));
    if (jp >> 2)
      w[1] |= v;
    else
      w[0] |= v;
  }
  __device__ __forceinline__ uint32_t* at(int i) const {
    const int warp = (threadIdx.x >> 5) & 7;
    const int tid = 128 * blk + 32 * (warp >> 1) + (threadIdx.x & 31);
    return rec + ((long long)i * CONSUMERS + tid) * 4 + 2 * (warp & 1);
  }
  __device__ __forceinline__ void trunk(int m, int c, int, const float (&h)[8]) const {
    const int me = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t b = __ballot_sync(0xffffffffu, h[r] > 0.f);
      if (r == me) mine = b;
    }
    const int jp = c >> 5;
    take(jp);
    if (jp == HID / 32 - 1) {
      *reinterpret_cast<uint2*>(at(m)) = make_uint2(w[0], w[1]);
      w[0] = w[1] = 0u;
    }
  }
  // lane 0 of each warp: bit 0 of the dir record's words 1 and 3 for the 4
  // threads of the row
  __device__ __forceinline__ void sigma_pre(int row, float v) const {
    const int tid = 128 * blk + 32 * (row >> 4) + 4 * (row & 7);
    uint32_t* p = rec + ((long long)num_layers * CONSUMERS + tid) * 4 + 2 * ((row >> 3) & 1) + 1;
#pragma unroll
    for (int t = 0; t < 4; ++t) p[4 * t] = v > 0.f ? 1u : 0u;
  }
  __device__ __forceinline__ void head(int row, int c, float hdir, float) const {
    const uint32_t b = __ballot_sync(0xffffffffu, hdir > 0.f);
    if ((row & 7) == ((threadIdx.x & 31) >> 2)) mine = b;
    if ((row & 7) == 7) {
      const int jp = c >> 5;
      take(jp);
      if (jp == HALF / 32 - 1) {
        *at(num_layers) = w[0];
        w[0] = 0u;
      }
    }
  }
};

// The gate pass of one pass's tiles: each tile's rays (field_f32.cuh
// load_rays: zeros past R), its two 64-row blocks through field_block (wt:
// the weights transposed, PackedParams.mats_kn), the gates to their records
// (tile c's at virtual tile c vt of gates: K9 keeps two row sets a tile).
// Rows of rays past R take zero encodings here and the tile kernel's
// encodings of a zero ray there; no cotangent reaches them.  A row tile
// (ROW_TILE, K8: rays.o the points, rpc = 128) loads each block's rows
// (load_rows) and encodes them at z = 0 (RowEnc), zeros past R as the tile
// kernel's.
template <int KIND>
__global__ void __launch_bounds__(f32::THREADS)
gate_pass32(const FieldArgs P, const float* __restrict__ wt, const f32::Rays32 rays,
            uint4* __restrict__ gates, int vt) {
  f32::Smem& sm = f32::smem_f32();
  const int L = P.num_layers;
  for (long long c = blockIdx.x; c < rays.n_tiles; c += gridDim.x) {
    const long long ray0 = c * rays.rpc;
    const int n = (int)(rays.R - ray0 < rays.rpc ? rays.R - ray0 : rays.rpc);
    uint32_t* rec = reinterpret_cast<uint32_t*>(gates + c * vt * (L + 1) * CONSUMERS);
    if constexpr (KIND == ROW_TILE) {
      for (int b = 0; b < ROWS / f32::MB; ++b) {
        const int nb = min(max(n - b * f32::MB, 0), f32::MB);
        f32::load_rows(sm, rays, ray0 + b * f32::MB, nb);
        f32::field_block(P, wt, sm, f32::RowEnc{P, rays.emb, ray0 + b * f32::MB, nb},
                         sm.rgb + b * f32::MB * 3, sm.sigma + b * f32::MB,
                         GateStash{rec, b, L});
      }
    } else {
      __syncthreads();  // every thread is done with the last tile's rays
      f32::load_rays(sm, rays, ray0, n);
      for (int b = 0; b < ROWS / f32::MB; ++b)
        f32::field_block(P, wt, sm, f32::RayEnc{P, rays.emb, ray0, b * f32::MB, rays.s, n},
                         sm.rgb + b * f32::MB * 3, sm.sigma + b * f32::MB,
                         GateStash{rec, b, L});
    }
  }
}

// ---------------------------------------------------------------- forward

// field_tile's stash hook (one a consumer thread, for tile rows at stash
// row g0; gin: the tile's gate records): the gate pass's gates (layer i's
// record loaded at begin(i), the dir layer's and sigma's with the last
// trunk layer's), each trunk layer's output split into the 8-row-group
// planes of hs, sigma_pre and happ.
struct StashRes {
  uint32_t* hs;
  float* happ;
  const uint4* gin;
  float* sp;
  long long g0, plane;  // plane: floats of one hi or lo plane
  int num_layers;
  uint4 m = make_uint4(0u, 0u, 0u, 0u);   // the current trunk layer's record
  uint4 md = make_uint4(0u, 0u, 0u, 0u);  // the dir layer's

  __device__ __forceinline__ void begin(int i) {
    if (i == num_layers) return;
    m = __ldg(gin + i * CONSUMERS + threadIdx.x);
    if (i == num_layers - 1) md = __ldg(gin + num_layers * CONSUMERS + threadIdx.x);
  }
  __device__ __forceinline__ static float2 gated(const uint4& g, int h, int j, float x0,
                                                 float x1) {
    const uint32_t bits = (j < 16 ? (h ? g.z : g.x) : (h ? g.w : g.y)) >> (j & 15);
    return make_float2((bits & 1u) ? x0 : 0.f, (bits & 0x10000u) ? x1 : 0.f);
  }
  __device__ __forceinline__ float2 relu(int h, int j, float x0, float x1) const {
    return gated(m, h, j, x0, x1);
  }
  __device__ __forceinline__ float2 relu_dir(int h, int j, float x0, float x1) const {
    return gated(md, h, j, x0, x1);
  }
  __device__ __forceinline__ float relu_sigma(int h, float v) const {
    return ((h ? md.w : md.y) & 1u) ? v : 0.f;
  }
  __device__ __forceinline__ void trunk(int i, int h, int j, float v0, float v1) {
    const int row = frag_row() + 8 * h, col = 8 * j + 2 * (threadIdx.x & 3);
    uint32_t* p = hs + 2 * i * plane + (((g0 + row) >> 3) * HID + col) * 8 + (row & 7);
    uint32_t hi0, lo0, hi1, lo1;
    split_tf32(v0, hi0, lo0);
    split_tf32(v1, hi1, lo1);
    p[0] = hi0;
    p[8] = hi1;
    p[plane] = lo0;
    p[plane + 8] = lo1;
  }
  __device__ __forceinline__ void sigma_pre(int row, float v) { sp[row] = v; }
  __device__ __forceinline__ void dir(int h, int j, float, float, float h0, float h1) {
    const int row = frag_row() + 8 * h, col = 8 * j + 2 * (threadIdx.x & 3);
    *reinterpret_cast<float2*>(happ + (g0 + row) * HALF + col) = make_float2(h0, h1);
  }
};

// load_tiles' stash hook (the encoders): tile c's encodings, as the forward
// forms them (field_f32_sm90.cuh enc_x_at, enc_d_at; zeros past the tile's
// rays), and each row's embedding (zeros past R), to the stash rows of the
// tile: those of virtual tile tile vt + v0 (K9: vt = 2, v0 its coarse 0 or
// fine 1 row set).  A row tile's (load_row_tiles): each row's at z = 0,
// zeros past its rows.
struct StashEnc {
  const FieldArgs& P;
  const ScratchT32& sc;
  const float* emb;
  long long R;
  int s, rpc, vt = 1, v0 = 0;

  __device__ __forceinline__ long long stash_row(int c) const {
    return ((blockIdx.x + (long long)c * gridDim.x) * vt + v0) * ROWS;
  }
  __device__ __forceinline__ void operator()(const TileRows& rw, int c, long long row0) const {
    const int et = threadIdx.x - sm90::ENC0, kx = P.kx, kd = P.kd, E = P.emb_dim, n = rw.n;
    const long long g0 = stash_row(c);
    for (int idx = et; idx < ROWS * kx; idx += sm90::ENCODERS) {
      const int row = idx / kx, col = idx - row * kx;
      sc.encx[g0 * kx + idx] =
          row < n ? enc_x_at(P, col, rw.x + 3 * row, rw.d + 3 * row, 0.f, rw.t[row]) : 0.f;
    }
    for (int idx = et; idx < ROWS * kd; idx += sm90::ENCODERS) {
      const int row = idx / kd, col = idx - row * kd;
      sc.encd[g0 * kd + idx] = row < n ? enc_d_at(P, col, rw.d + 3 * row) : 0.f;
    }
    for (int idx = et; idx < ROWS * E; idx += sm90::ENCODERS) {
      const int row = idx / E;
      sc.embr[g0 * E + idx] = row < n ? emb[row0 * E + idx] : 0.f;
    }
  }
  __device__ __forceinline__ void operator()(const TileRays& tr, int c, long long ray0) const {
    const int et = threadIdx.x - sm90::ENC0, kx = P.kx, kd = P.kd, E = P.emb_dim;
    const long long g0 = stash_row(c);
    for (int idx = et; idx < ROWS * kx; idx += sm90::ENCODERS) {
      const int row = idx / kx, col = idx - row * kx, j = row / s;
      sc.encx[g0 * kx + idx] =
          j < rpc ? enc_x_at(P, col, tr.o + 3 * j, tr.d + 3 * j, tr.z[row], tr.t[j]) : 0.f;
    }
    for (int idx = et; idx < ROWS * kd; idx += sm90::ENCODERS) {
      const int row = idx / kd, col = idx - row * kd, j = row / s;
      sc.encd[g0 * kd + idx] = j < rpc ? enc_d_at(P, col, tr.d + 3 * j) : 0.f;
    }
    for (int idx = et; idx < ROWS * E; idx += sm90::ENCODERS) {
      const int row = idx / E, e = idx - row * E, j = row / s;
      sc.embr[g0 * E + idx] = (j < rpc && ray0 + j < R) ? emb[(ray0 + j) * E + e] : 0.f;
    }
  }
};

// ---------------------------------------------------------------- producer

// The weight stream (the producer warpgroup's first thread): for every tile
// of this CTA, the forward's K slices (field_f32_sm90.cuh stream_tile),
// then, once the composite is off the ring, the transposed chain's `chains`
// times (K9: the fine row set's, then the coarse one's): the dir layer's
// (HALF / KS slices), then the trunk layers' from the last to layer 1 (HID /
// KS each), all 256 inputs a stage.
__device__ __forceinline__ void stream_bwd(const BwdMapsT32& maps, const FieldArgs& P,
                                           long long n_tiles, int chains) {
  SmemT32& sm = smem_t32();
  const uint32_t ring = smem_u32(&sm);
  const uint32_t full = ring + offsetof(Smem32, full), empty = ring + offsetof(Smem32, empty);
  Pipe pp;
  auto chain_slice = [&](const CUtensorMap* m, int k0, int row) {
    mbar_wait_at(empty + 8 * pp.stage, pp.phase ^ 1);
    mbar_expect_tx(full + 8 * pp.stage, STAGE_BYTES);
    tma_load3_at(ring + pp.stage * STAGE_BYTES, m, k0, row, 0, full + 8 * pp.stage);
    pp.advance();
  };
  const int tiles = my_tiles(n_tiles);
  for (int c = 0; c < tiles; ++c) {
    stream_tile(maps.fwd, P, pp);
    mbar_wait(&sm.comp_done, c & 1);
    for (int q = 0; q < chains; ++q) {
      for (int k0 = 0; k0 < HALF; k0 += KS) chain_slice(&maps.dir, k0, 0);
      for (int i = P.num_layers - 1; i >= 1; --i)
        for (int k0 = 0; k0 < HID; k0 += KS)
          chain_slice(&maps.trunk, k0, (int)(P.w_off[i] / HID));
    }
  }
}

// The producer warpgroup: gives registers up (field_f32_sm90.cuh produce's
// split), then its first thread streams the weights (the forward's, then
// `chains` transposed chains a tile; chains = 0: the forward's only) and
// its warps 1-3 load the tiles' rays (rows), stash their encodings as
// stash does and form their appearance terms (rays).
template <int KIND = RAYS>
__device__ __forceinline__ void produce_bwd(const BwdMapsT32& maps, const FieldArgs& P,
                                            const float* W, const Rays& rays,
                                            const StashEnc& stash, int chains = 1) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
  if (threadIdx.x >= sm90::ENC0) {
    if constexpr (KIND == ROW_TILE)
      load_row_tiles(rays, stash);
    else
      load_tiles(P, W, rays, stash);
  } else if (threadIdx.x == CONSUMERS) {
    if (chains == 0)
      stream_weights(maps.fwd, P, rays.n_tiles);
    else
      stream_bwd(maps, P, rays.n_tiles, chains);
  }
}

// ---------------------------------------------------------------- chain

// What the chain's head does with the rows' d_happ: each ray's sum over its
// s rows into bs.dsum, then the rays' demb (K3, K4, K6, K7: DEMB_RAYS); the sums
// only (K9's fine row set: DEMB_KEEP); the sums added to bs.dsum, then the
// rays' demb (K9's coarse row set, after its fine one: DEMB_ADD); each
// row's demb = d_happ @ Wapp (K8's row tile: DEMB_ROWS).
enum DembMode { DEMB_RAYS = 0, DEMB_KEEP = 1, DEMB_ADD = 2, DEMB_ROWS = 3 };

// Trunk layer i's output at (row, col) and (row, col + 1) of the tile at
// stash row g0 read back from its split in the stash, hi + lo: within 2^-22
// of the f32 value, as the dW pass's B operand reads it.
__device__ __forceinline__ float2 stashed_out(const ScratchT32& sc, int i, long long g0, int row,
                                              int col) {
  const long long plane = sc.rows * HID;
  const uint32_t* p = sc.hs + 2 * i * plane + (((g0 + row) >> 3) * HID + col) * 8 + (row & 7);
  return make_float2(__uint_as_float(p[0]) + __uint_as_float(p[plane]),
                     __uint_as_float(p[8]) + __uint_as_float(p[plane + 8]));
}

// The chain's head after the composite (bs.g_rgb / bs.g_sig set for every
// row, zero on rows of no ray), on the consumers' accumulator fragments
// (rows row0, row0 + 8 a thread; each row's 4 lanes hold its values):
// d_pre_rgb (stashed) and d_sigma_pre per row; the rgb and density heads'
// row sums and wd's (over the last trunk output, still in sm.act, or with
// H_STASH read back from the stash: K9's coarse row set, whose forward ran
// before the fine one's) into the warp's slot; d_happ = d_pre_rgb @ Wrgb
// and d_hdir_pre = gate ? d_happ : 0, both stashed, written into sm.act
// (columns 0.. d_hdir_pre, the first product's A; HALF.. d_happ) with the
// bapp / bdir row sums; then demb as MODE says (DembMode; rays ray0..,
// nvalid of them, or a row tile's rows ray0..).  W: the packed f32
// weights; md: the thread's dir-layer gate record (the dir gates, sigma's
// under relu).
template <int MODE = DEMB_RAYS, bool H_STASH = false>
__device__ __forceinline__ void chain_head(const FieldArgs& P, const float* __restrict__ W,
                                           SmemT32& sm, const ScratchT32& sc, long long g0,
                                           float* slot, const uint4 md, int s,
                                           int nvalid, long long ray0, float* __restrict__ demb) {
  const int lane = threadIdx.x & 31, t = lane & 3, row0 = frag_row();
  BwdSmem& bs = sm.bs;
  float* act = sm.f.act;
  float dp[2][3], ds[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float y = sm.f.rgb[row * 3 + k];
      dp[h][k] = bs.g_rgb[row * 3 + k] * y * (1.f - y);
    }
    const float sp = sm.sigma_pre[row];
    const float a = P.softplus ? 1.f / (1.f + expf(-sp)) : (((h ? md.w : md.y) & 1u) ? 1.f : 0.f);
    ds[h] = bs.g_sig[row] * a;
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) bs.dpr[row * 3 + k] = dp[h][k];
      bs.dsp[row] = ds[h];
      *reinterpret_cast<float4*>(sc.drgb + (g0 + row) * DRGB32) =
          make_float4(dp[h][0], dp[h][1], dp[h][2], 0.f);
    }
  }
  {
    // brgb and bd over the warp's 16 rows: the 8 row pairs in a fixed tree
    float a[4] = {dp[0][0] + dp[1][0], dp[0][1] + dp[1][1], dp[0][2] + dp[1][2], ds[0] + ds[1]};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
    if (lane == 0) {
      slot[P.brgb_off + 0] = a[0];
      slot[P.brgb_off + 1] = a[1];
      slot[P.brgb_off + 2] = a[2];
      slot[P.bd_off] = a[3];
    }
  }
  // wd: the last trunk output times d_sigma_pre, summed over the rows
#pragma unroll
  for (int j0 = 0; j0 < HID / 8; j0 += 4) {
    float cs[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 8 * (j0 + jj) + 2 * t;
      float2 x0, x1;
      if constexpr (H_STASH) {
        x0 = stashed_out(sc, P.num_layers - 1, g0, row0, col);
        x1 = stashed_out(sc, P.num_layers - 1, g0, row0 + 8, col);
      } else {
        x0 = *reinterpret_cast<const float2*>(act + off32(row0, col));
        x1 = *reinterpret_cast<const float2*>(act + off32(row0 + 8, col));
      }
      cs[2 * jj] = x0.x * ds[0] + x1.x * ds[1];
      cs[2 * jj + 1] = x0.y * ds[0] + x1.y * ds[1];
    }
    slot[P.wd_off + sum8_col(j0, lane)] = sum8(cs);
  }
  // d_happ and d_hdir_pre (the thread's own elements of sm.act: the reads
  // above are done)
  const float* wrgb = W + P.wrgb_off;  // (3, HALF)
#pragma unroll
  for (int j0 = 0; j0 < HALF / 8; j0 += 4) {
    float sa[8], sd[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj, col = 8 * j + 2 * t;
      const float2 w0 = __ldg(reinterpret_cast<const float2*>(wrgb + col));
      const float2 w1 = __ldg(reinterpret_cast<const float2*>(wrgb + HALF + col));
      const float2 w2 = __ldg(reinterpret_cast<const float2*>(wrgb + 2 * HALF + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const float dh0 = dp[h][0] * w0.x + dp[h][1] * w1.x + dp[h][2] * w2.x;
        const float dh1 = dp[h][0] * w0.y + dp[h][1] * w1.y + dp[h][2] * w2.y;
        const uint32_t bits = (h ? md.z : md.x) >> j;
        const float dd0 = (bits & 1u) ? dh0 : 0.f, dd1 = (bits & 0x10000u) ? dh1 : 0.f;
        *reinterpret_cast<float2*>(act + off32(row, col)) = make_float2(dd0, dd1);
        *reinterpret_cast<float2*>(act + off32(row, HALF + col)) = make_float2(dh0, dh1);
        const long long at = (g0 + row) * HALF + col;
        *reinterpret_cast<float2*>(sc.dapp + at) = make_float2(dh0, dh1);
        *reinterpret_cast<float2*>(sc.ddir + at) = make_float2(dd0, dd1);
        sa[2 * jj] = h ? sa[2 * jj] + dh0 : dh0;
        sa[2 * jj + 1] = h ? sa[2 * jj + 1] + dh1 : dh1;
        sd[2 * jj] = h ? sd[2 * jj] + dd0 : dd0;
        sd[2 * jj + 1] = h ? sd[2 * jj + 1] + dd1 : dd1;
      }
    }
    const int col = sum8_col(j0, lane);
    slot[P.bapp_off + col] = sum8(sa);
    slot[P.bdir_off + col] = sum8(sd);
  }
  consumers_sync();  // every row's d_happ is in sm.act
  if constexpr (MODE == DEMB_ROWS) {
    // each row's demb (4 outputs a thread), summed over c in order
    const float* wapp = W + P.wapp_off;  // (HALF, E)
    const int E = P.emb_dim, q4 = E / 4;
    for (int idx = threadIdx.x; idx < nvalid * q4; idx += CONSUMERS) {
      const int r = idx / q4, e0 = 4 * (idx - r * q4);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int c = 0; c < HALF; ++c) {
        const float dh = act[off32(r, HALF + c)];
        const float4 w = __ldg(reinterpret_cast<const float4*>(wapp + c * E + e0));
        a0 += dh * w.x;
        a1 += dh * w.y;
        a2 += dh * w.z;
        a3 += dh * w.w;
      }
      *reinterpret_cast<float4*>(demb + (ray0 + r) * E + e0) = make_float4(a0, a1, a2, a3);
    }
    consumers_sync();  // every read of d_happ in sm.act
  } else {
    for (int idx = threadIdx.x; idx < nvalid * HALF; idx += CONSUMERS) {
      const int j = idx / HALF, col = idx - j * HALF;
      float a = 0.f;
      for (int r = j * s; r < (j + 1) * s; ++r) a += act[off32(r, HALF + col)];
      if constexpr (MODE == DEMB_ADD)
        bs.dsum[idx] += a;
      else
        bs.dsum[idx] = a;
    }
    consumers_sync();  // the sums are done, and every read of d_happ in sm.act
    if constexpr (MODE != DEMB_KEEP) f32::ray_demb(P, W, bs, ray0, nvalid, demb);
  }
}

// A transposed product's epilogue: d_pre_i = gate ? acc (+ d_sigma_pre wd
// at the dir step) : 0 with the thread's gate record m of layer i, into
// sm.act (the next product's A; not for layer 0) and the stash (stash rows
// g0..), its column sums (bias i) into the warp's slot.
template <bool DIR>
__device__ __forceinline__ void chain_epilogue(const FieldArgs& P, const float (&acc)[ACC],
                                               const uint4 m, SmemT32& sm, const ScratchT32& sc,
                                               int i, long long g0, float* slot) {
  const int lane = threadIdx.x & 31, t = lane & 3, row0 = frag_row();
  float ds[2] = {0.f, 0.f};
  if constexpr (DIR) {
    ds[0] = sm.bs.dsp[row0];
    ds[1] = sm.bs.dsp[row0 + 8];
  }
  float* dout = sc.dpre + ((long long)i * sc.rows + g0) * HID;
#pragma unroll
  for (int j0 = 0; j0 < HID / 8; j0 += 4) {
    float cs[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj, col = 8 * j + 2 * t;
      float2 w = make_float2(0.f, 0.f);
      if constexpr (DIR) w = __ldg(reinterpret_cast<const float2*>(P.vecs + P.wd_off + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const uint32_t bits = (j < 16 ? (h ? m.z : m.x) : (h ? m.w : m.y)) >> (j & 15);
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (DIR) {
          v0 += ds[h] * w.x;
          v1 += ds[h] * w.y;
        }
        const float d0 = (bits & 1u) ? v0 : 0.f, d1 = (bits & 0x10000u) ? v1 : 0.f;
        if (i > 0) *reinterpret_cast<float2*>(sm.f.act + off32(row, col)) = make_float2(d0, d1);
        *reinterpret_cast<float2*>(dout + (long long)row * HID + col) = make_float2(d0, d1);
        cs[2 * jj] = h ? cs[2 * jj] + d0 : d0;
        cs[2 * jj + 1] = h ? cs[2 * jj + 1] + d1 : d1;
      }
    }
    slot[P.b_off[i] + sum8_col(j0, lane)] = sum8(cs);
  }
  __syncwarp();  // the warp's rows are in place before its lanes read them
}

// The transposed chain on the tile: the dir layer's block (A = d_hdir_pre in
// sm.act, K = HALF) gives d_pre of the last trunk layer, then trunk layer
// i's block (A = d_pre_i in place, K = HID) d_pre_{i-1}, down to d_pre_0;
// gin: the tile's gate records.
__device__ __forceinline__ void chain(const FieldArgs& P, SmemT32& sm, const ScratchT32& sc,
                                      const uint4* gin, long long g0, float* slot, Pipe& pp,
                                      float (&acc)[ACC]) {
  const int L = P.num_layers, t = threadIdx.x & 3, row0 = frag_row();
  for (int q = 0; q < L; ++q) {
    const int i = L - 1 - q;  // the layer whose d_pre this product forms
    mma_slices<HID, true>(acc, sm.f, (q == 0 ? HALF : HID) / KS, pp, [&](AFrag& f, int sl) {
      float v[4];
      act_vals(v, sm.f, KS * sl, row0, t);
      split_frag(f, v);
    });
    const uint4 m = __ldg(gin + i * CONSUMERS + threadIdx.x);
    if (q == 0)
      chain_epilogue<true>(P, acc, m, sm, sc, i, g0, slot);
    else
      chain_epilogue<false>(P, acc, m, sm, sc, i, g0, slot);
    dead_acc(acc);
  }
}

// ---------------------------------------------------------------- tile

// The tile kernel (pass 1) of K3, K4, K6, K7 and K8: for each tile of this
// CTA (rays ray_base + tile rpc.. of the launch, stash rows tile ROWS..; rays:
// the pass's, its pointers and R from ray_base on; K8, Comp::ROWS: rows, a
// row tile's 128 each, s = 1), the forward with its residuals, the
// composite and its transpose (comp, on absolute ray indices), the chain's
// head and the transposed chain, on the gate pass's gates (sc.gates).
template <class Comp>
__global__ void __launch_bounds__(THREADS, 1)
bwd_tile32(const __grid_constant__ BwdMapsT32 maps, const FieldArgs P, const float* __restrict__ W,
           const ScratchT32 sc, const Rays rays, long long ray_base, const Comp comp,
           float* __restrict__ demb) {
  constexpr int KIND = Comp::ROWS ? ROW_TILE : RAYS;
  SmemT32& sm = smem_t32();
  if (threadIdx.x == 0) mbar_init(&sm.comp_done, 1);
  init32(sm.f);
  if (threadIdx.x >= CONSUMERS) {
    produce_bwd<KIND>(maps, P, W, rays, StashEnc{P, sc, rays.emb, rays.R, rays.s, rays.rpc});
    return;
  }
  consumer_regs();
  const int s = rays.s, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const int warp = threadIdx.x >> 5;
  Scratch sums{};  // store_tile_loss reads part and nv only
  sums.part = sc.part;
  sums.nv = sc.nv;
  Pipe pp;
  float acc[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long tile = blockIdx.x + (long long)c * gridDim.x;
    const long long ray0 = tile * rpc, g0 = tile * ROWS;
    const int nvalid = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    for (int r = threadIdx.x; r < ROWS; r += CONSUMERS) {
      sm.bs.g_sig[r] = 0.f;
      sm.bs.g_rgb[r * 3 + 0] = 0.f;
      sm.bs.g_rgb[r * 3 + 1] = 0.f;
      sm.bs.g_rgb[r * 3 + 2] = 0.f;
    }
    const uint4* gin = sc.gates + tile * (P.num_layers + 1) * CONSUMERS;
    StashRes res{sc.hs, sc.happ, gin, sm.sigma_pre, g0, sc.rows * HID, P.num_layers};
    field_tile<KIND>(P, W, sm.f, c, s, rpc, pp, acc, res, rays.emb + ray0 * P.emb_dim);
    dead_acc(acc);
    comp(CompTile<ConsumerSync>{KIND == ROW_TILE ? nullptr : sm.f.tr[c & 1].z, sm.f.sigma,
                                sm.f.rgb, sm.bs, reinterpret_cast<float*>(sm.f.ring), {}},
         ray_base + ray0, nvalid, rpc);
    fence_proxy_async();  // the ring's generic writes before the producer's next loads
    consumers_sync();
    if (threadIdx.x == 0) {
      mbar_arrive(&sm.comp_done);
      mbar_arrive(&sm.f.tr_empty[in_buf<KIND>(c)]);
    }
    store_tile_loss<Comp::MSE>(sm.bs, sums, (int)(SLOTS * tile), nvalid);
    float* slot = sc.part + (SLOTS * tile + warp) * sc.nv;
    chain_head<KIND == ROW_TILE ? DEMB_ROWS : DEMB_RAYS>(P, W, sm, sc, g0, slot, res.md, s,
                                                          nvalid, ray_base + ray0, demb);
    chain(P, sm, sc, gin, g0, slot, pp, acc);
  }
}

// ------------------------------------------------------------- pass 2: dW

// The wgmma dW job of block blk (of 2 (L - 1) + 1): trunk layer i = 1 +
// blk / 2, output rows 128 (blk & 1).. of dW_i[:, :HID] = d_pre_i^T
// h_{i-1}; the last block the dir layer's Wdir[:, :HID] = d_hdir_pre^T
// h_{L-1}.
struct DwJobT32 {
  int layer;  // the layer whose d_pre is A (L: the dir layer, A = ddir)
  int out0;   // the first output row
  float* c;   // where its rows go in the packed gradients
  int ldc;
};

__host__ __device__ inline DwJobT32 dw_t32_job(const FieldArgs& P, float* gmats, int blk) {
  const int L = P.num_layers;
  if (blk == 2 * (L - 1)) return {L, 0, gmats + P.wdir_off, HID + P.kd};
  const int i = 1 + blk / 2;
  const int ldc = ((P.skip_mask >> i) & 1) ? HID + P.kx : HID;
  return {i, DWT_ROWS * (blk & 1), gmats + P.w_off[i] + (long long)DWT_ROWS * (blk & 1) * ldc, ldc};
}

// A = the slab's d_pre (m: output row, k: slab row) from its four 128-byte
// swizzled 32 x 8 boxes at a: the thread's fragment, split.
__device__ __forceinline__ void dw_frag(AFrag& f, const unsigned char* a, int m0, int t) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + 8 * (q & 1), k = t + 4 * (q >> 1), cb = m & 31;
    v[q] = *reinterpret_cast<const float*>(a + (m >> 5) * 1024 + k * 128 +
                                           ((((cb >> 2) ^ k) & 7) << 4) + (cb & 3) * 4);
  }
  split_frag(f, v);
}

// The dW products of one slab: acc += A_lo B_hi + A_hi B_lo + A_hi B_hi, B
// the slab's split input at b_hi (hi), b_hi + 8 KB (lo).
__device__ __forceinline__ void dw_slab(float (&acc)[ACC], const AFrag& f, uint32_t b_hi) {
  const uint64_t dh = make_desc(b_hi, ROW_BYTES), dl = make_desc(b_hi + HID * ROW_BYTES, ROW_BYTES);
  sm90::wgmma_fence();
  wgmma_tf32<HID>(acc, f.lo, dh, 1);
  wgmma_tf32<HID>(acc, f.hi, dl, 1);
  wgmma_tf32<HID>(acc, f.hi, dh, 1);
  sm90::wgmma_commit();
}

// One CTA: block blockIdx.x over the rows of partition blockIdx.y of the
// pass's `rows` (stash rows_s a layer); its partial sum goes to dwpart.
// Warpgroup g owns output rows 64 g..; thread CONSUMERS streams the slabs.
__global__ void __launch_bounds__(DWT_THREADS, 1)
dw_t32_kernel(const __grid_constant__ DwMapsT32 maps, const FieldArgs P, long long rows_s,
              long long rows, float* __restrict__ dwpart) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  SmemDwT& sm = *reinterpret_cast<SmemDwT*>(smem_raw);
  if (threadIdx.x == 0) {
    if (smem_u32(&sm) & 1023) __trap();
    for (int s = 0; s < DWT_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const DwJobT32 jb = dw_t32_job(P, nullptr, blockIdx.x);
  const bool dir = jb.layer == P.num_layers;
  const long long per = (rows + gridDim.y * (long long)KS - 1) / (gridDim.y * (long long)KS) * KS;
  const long long r_begin = blockIdx.y * per;
  const long long r_end = r_begin + per < rows ? r_begin + per : rows;
  const int n_slabs = r_end > r_begin ? (int)((r_end - r_begin) / KS) : 0;

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* am = dir ? &maps.ddir : &maps.dpre;
      const long long a_row = dir ? 0 : jb.layer * rows_s;
      const int b_plane = 2 * (jb.layer - 1);
      Pipe pp;
      for (int i = 0; i < n_slabs; ++i) {
        const long long r = r_begin + (long long)KS * i;
        const uint32_t st = smem_u32(sm.st[pp.stage]), full = smem_u32(&sm.full[pp.stage]);
        mbar_wait(&sm.empty[pp.stage], pp.phase ^ 1);
        mbar_expect_tx(full, DWT_B + DWT_A);
        tma_load3_at(st, &maps.hs, 0, (int)(HID * (r / KS)), b_plane, full);
        for (int q = 0; q < 4; ++q)
          sm90::tma_load_at(st + DWT_B + q * 1024, am, jb.out0 + 32 * q, (int)(a_row + r), full);
        if (++pp.stage == DWT_STAGES) {
          pp.stage = 0;
          pp.phase ^= 1;
        }
      }
    }
    return;
  }
  const int g = threadIdx.x >> 7, t = threadIdx.x & 3;
  const int m0 = g * 64 + ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  float acc[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = 0.f;
  AFrag f0, f1;
  int st = 0, ph = 0, prev = -1;
  for (int i = 0; i < n_slabs; ++i) {
    mbar_wait(&sm.full[st], ph);
    const unsigned char* a = sm.st[st] + DWT_B;
    if (i & 1) {
      dw_frag(f1, a, m0, t);
      dw_slab(acc, f1, smem_u32(sm.st[st]));
    } else {
      dw_frag(f0, a, m0, t);
      dw_slab(acc, f0, smem_u32(sm.st[st]));
    }
    if (prev >= 0) {
      sm90::wgmma_wait<1>();  // the slab before is done: its stage and fragment set are free
      if (i & 1)
        fence_frag(f0);
      else
        fence_frag(f1);
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[prev]);
    }
    prev = st;
    if (++st == DWT_STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
  sm90::wgmma_wait<0>();
  fence_frag(f0);
  fence_frag(f1);
  fence_acc(acc);
  const int lane = threadIdx.x & 31;
  float* out = dwpart + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * DWT_ROWS * HID;
#pragma unroll
  for (int j = 0; j < HID / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (m0 + 8 * h) * HID + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// gmats += the sum of the partitions' partial blocks, in partition order.
__global__ void dw_t32_reduce(const FieldArgs P, float* gmats, const float* __restrict__ dwpart,
                              int blocks, int parts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)blocks * DWT_ROWS * HID) return;
  const int blk = (int)(idx / (DWT_ROWS * HID));
  const int e = (int)(idx - (long long)blk * DWT_ROWS * HID);
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += dwpart[((long long)p * blocks + blk) * DWT_ROWS * HID + e];
  const DwJobT32 jb = dw_t32_job(P, gmats, blk);
  jb.c[(long long)(e / HID) * jb.ldc + e % HID] += s;
}

// ------------------------------------------------------------------ host

// The narrow dW jobs of a pass over `rows` stash rows on dw32_kernel (gmats
// null: to count their tiles): encx of layer 0 and the skips, encd, the
// appearance projection, the rgb head.
inline int narrow_jobs(const FieldArgs& P, const ScratchT32& sc, float* gmats, long long rows,
                       Dw32Jobs* J) {
  J->n = 0;
  J->rows = rows;
  const long long ls = sc.rows * HID;
  const int kx = P.kx, kd = P.kd, E = P.emb_dim;
  auto at = [&](long long off) { return gmats == nullptr ? nullptr : gmats + off; };
  int n = 0;
  add_job32(*J, n, sc.dpre, HID, HID, HID, sc.encx, kx, kx, at(P.w_off[0]), kx);
  for (int i = 1; i < P.num_layers; ++i)
    if ((P.skip_mask >> i) & 1)
      add_job32(*J, n, sc.dpre + i * ls, HID, HID, HID, sc.encx, kx, kx, at(P.w_off[i] + HID),
                HID + kx);
  add_job32(*J, n, sc.ddir, HALF, HALF, HALF, sc.encd, kd, kd, at(P.wdir_off + HID), HID + kd);
  add_job32(*J, n, sc.dapp, HALF, HALF, HALF, sc.embr, E, E, at(P.wapp_off), E);
  add_job32(*J, n, sc.drgb, DRGB32, DRGB32, 3, sc.happ, HALF, HALF, at(P.wrgb_off), HALF);
  return n;
}

// Lay the stash out from base (or only measure it, base == nullptr) for
// `tiles` tiles of rows; returns its size in bytes.
inline long long carve_t32(char* base, const FieldArgs& P, long long tiles, int n_vecs,
                           ScratchT32* s) {
  const long long rows = tiles * ROWS;
  long long off = 0;
  auto take = [&](long long floats) -> float* {
    float* p = base ? reinterpret_cast<float*>(base + off) : nullptr;
    off += (floats * (long long)sizeof(float) + 1023) / 1024 * 1024;
    return p;
  };
  const int L = P.num_layers;
  s->rows = rows;
  s->hs = reinterpret_cast<uint32_t*>(take(2 * L * rows * HID));
  s->dpre = take(L * rows * HID);
  s->encx = take(rows * P.kx);
  s->encd = take(rows * P.kd);
  s->happ = take(rows * HALF);
  s->dapp = take(rows * HALF);
  s->ddir = take(rows * HALF);
  s->drgb = take(rows * DRGB32);
  s->embr = take(rows * P.emb_dim);
  s->nv = n_vecs + 1;
  s->part = take(SLOTS * tiles * s->nv);
  Dw32Jobs J;
  s->dw_tiles = narrow_jobs(P, *s, nullptr, rows, &J);
  s->dwpart = take((long long)f32::DW32_PARTS * s->dw_tiles * f32::DW32_TILE * f32::DW32_TILE);
  s->blocks = 2 * (L - 1) + 1;
  s->dwpart90 = take((rows + DWT_PART_ROWS - 1) / DWT_PART_ROWS * s->blocks * DWT_ROWS * HID);
  s->gates = reinterpret_cast<uint4*>(take(tiles * (L + 1) * CONSUMERS * 4));
  return off;
}

// An f32 tensor map of rank 2 or 3: dims (d0, d1[, d2]), the byte strides
// of dims 1 (and 2), boxes of b0 x b1 (x b2), swizzle sw.
inline int map_f32(sm90::EncodeTiledFn enc, CUtensorMap* m, const void* p, int rank,
                   long long d0, long long d1, long long d2, long long s1, long long s2, int b0,
                   int b1, int b2, CUtensorMapSwizzle sw) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(p), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// What K3, K4, K6-K9 set up: the layout records (meta_t: where the
// chain's blocks lie in mats_kn, at the packed offsets: -1, w_off[1..L-1],
// wdir_off, wapp_off), the shape checks (1..128 samples a tile row; K8,
// rows: s = ROW_TILES), the stash of one pass and the pass sizes for R rays
// of s samples in a tile's rows (K3, K7: S; K4, K6: Sf; K9: max(Sc, Sf)) or R rows;
// vt virtual tiles of the stash a tile (K9: 2, its coarse and fine row
// sets); extra bytes of the scratch past the stash (K9's kept arrays: at
// extra, a pointer into the scratch).
struct BwdT32Call {
  FieldArgs P;
  const float* w;               // the packed f32 weights (the heads, Wapp)
  const float* w_hi;            // their TF32 halves (PackedParams.mats_tf32)
  const float* w_lo;
  const float* wt;              // the weights transposed (PackedParams.mats_kn): the gate pass's
  const float* wt_hi;           // W^T's (PackedParams.mats_kn_tf32)
  const float* wt_lo;
  ScratchT32 sc;
  int rpc, tiles_pass;
  long long tiles_total;
};

// The tiles of a tile's rows: 128 rows for a row tile (s = ROW_TILES),
// else rays_per_tile; 0 for a shape the kernels do not take.
inline int tile_units_t32(long long s, bool rows) {
  if (rows) return s == ROW_TILES ? ROWS : 0;
  return (s < 1 || s > TILE_M) ? 0 : rays_per_tile(s);
}

// The stash of one pass over R rays (rows) in tiles of `units`, vt virtual
// tiles each: its tiles and bytes.
inline long long stash_t32_bytes(const FieldArgs& P, long long R, int units, int vt,
                                 long long n_vecs, long long* tiles_pass = nullptr) {
  long long tiles = (R + units - 1) / units;
  if (tiles > MAX_TILES_PASS32 / vt) tiles = MAX_TILES_PASS32 / vt;
  if (tiles_pass != nullptr) *tiles_pass = tiles;
  ScratchT32 sc;
  return carve_t32(nullptr, P, vt * tiles, (int)n_vecs, &sc);
}

inline int bwd_t32_setup(const long long* meta, long long n_meta, const float* w,
                         const float* w_hi, const float* w_lo, const float* wt,
                         const float* vecs, long long E,
                         const float* wt_hi, const float* wt_lo, const long long* meta_t,
                         long long n_meta_t, long long R, long long s, void* scratch,
                         long long scratch_bytes, long long n_vecs, BwdT32Call* c,
                         bool rows = false, int vt = 1, long long extra = 0,
                         char** extra_at = nullptr) {
  int err = parse_meta(meta, n_meta, nullptr, vecs, E, &c->P);
  if (err) return err;
  const FieldArgs& P = c->P;
  const int L = P.num_layers;
  if (n_meta_t != L + 2 || meta_t[L] != P.wdir_off || meta_t[L + 1] != P.wapp_off) return ERR_META;
  for (int i = 1; i < L; ++i)
    if (meta_t[i] != P.w_off[i] || P.w_off[i] % HID) return ERR_META;
  if (P.wdir_off % HID) return ERR_META;
  const int units = tile_units_t32(s, rows);
  if (P.emb_dim % 4 || 2 * L + 4 > f32::MAX_JOBS32 || n_vecs < 1 || units == 0 || R < 0)
    return ERR_SHAPE;
  c->w = w;
  c->w_hi = w_hi;
  c->w_lo = w_lo;
  c->wt = wt;
  c->wt_hi = wt_hi;
  c->wt_lo = wt_lo;
  c->rpc = units;
  c->tiles_total = (R + c->rpc - 1) / c->rpc;
  long long tiles = 0;
  const long long bytes = stash_t32_bytes(P, R, units, vt, n_vecs, &tiles);
  c->tiles_pass = (int)tiles;
  if (bytes + extra > scratch_bytes) return ERR_SHAPE;
  carve_t32(static_cast<char*>(scratch), P, vt * tiles, (int)n_vecs, &c->sc);
  if (extra_at != nullptr) *extra_at = static_cast<char*>(scratch) + bytes;
  return 0;
}

// Passes 2 and 3 for the nt tiles of one pass: the wgmma dW blocks, the
// narrow jobs on dw32_kernel, the row sums (SLOTS a tile; loss null: the
// loss column is not summed).
inline int finish_t32(const BwdT32Call& c, const DwMapsT32& dm, int nt, float* gmats,
                      float* gvecs, float* loss, int n_vecs, cudaStream_t stream) {
  const FieldArgs& P = c.P;
  const ScratchT32& sc = c.sc;
  const long long rows = (long long)nt * ROWS;
  const int parts = (int)((rows + DWT_PART_ROWS - 1) / DWT_PART_ROWS);
  dw_t32_kernel<<<dim3(sc.blocks, parts), DWT_THREADS, DWT_SMEM_BYTES, stream>>>(
      dm, P, sc.rows, rows, sc.dwpart90);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n90 = (long long)sc.blocks * DWT_ROWS * HID;
  dw_t32_reduce<<<(unsigned)((n90 + 255) / 256), 256, 0, stream>>>(P, gmats, sc.dwpart90,
                                                                     sc.blocks, parts);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  Dw32Jobs J;
  const int n = narrow_jobs(P, sc, gmats, rows, &J);
  if (n != sc.dw_tiles) return ERR_META;
  long long np = rows / f32::DW32_PART_ROWS;
  np = np < 1 ? 1 : (np > f32::DW32_PARTS ? f32::DW32_PARTS : np);
  f32::dw32_kernel<<<dim3(n, (unsigned)np), f32::DW32_THREADS, 0, stream>>>(J, sc.dwpart, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long n_el = (long long)n * f32::DW32_TILE * f32::DW32_TILE;
  f32::dw32_reduce<<<(unsigned)((n_el + 255) / 256), 256, 0, stream>>>(J, sc.dwpart, n, (int)np);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  f32::sum_slots32<<<(sc.nv + 31) / 32, 256, 0, stream>>>(sc.part, SLOTS * nt, sc.nv, n_vecs,
                                                          gvecs, loss);
  return (int)cudaGetLastError();
}

// The tensor maps of a call's tile kernels and dW pass (their weights' and
// its stash's), the dW pass's shared memory limit, and the card's SMs.
inline int t32_maps(const BwdT32Call& c, BwdMapsT32* pm, DwMapsT32* pdm, int* n_sm) {
  const FieldArgs& P = c.P;
  const ScratchT32& sc = c.sc;
  const int L = P.num_layers;
  const sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  BwdMapsT32& maps = *pm;
  DwMapsT32& dm = *pdm;
  const long long fstride = (long long)(c.w_lo - c.w_hi) * 4;
  const long long tstride = (long long)(c.wt_lo - c.wt_hi) * 4;
  if (fstride <= 0 || fstride % 16 || tstride <= 0 || tstride % 16) return ERR_SHAPE;
  int err = 0;
  for (int i = 0; i <= L && !err; ++i) {
    const bool dir = i == L;
    err = split_map(enc, &maps.fwd.m[i], c.w_hi + (dir ? P.wdir_off : P.w_off[i]), fstride,
                    layer_k(P, i), dir ? HALF : HID);
  }
  const auto sw32 = CU_TENSOR_MAP_SWIZZLE_32B, sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!err)
    err = map_f32(enc, &maps.trunk, c.wt_hi, 3, HID, P.wdir_off / HID, 2, HID * 4, tstride, KS,
                  HID, 2, sw32);
  if (!err)
    err = map_f32(enc, &maps.dir, c.wt_hi + P.wdir_off, 3, HALF, HID, 2, HALF * 4, tstride, KS,
                  HID, 2, sw32);
  if (!err)
    err = map_f32(enc, &dm.hs, sc.hs, 3, KS, HID * (sc.rows / KS), 2 * L, KS * 4,
                  sc.rows * HID * 4, KS, HID, 2, sw32);
  if (!err)
    err = map_f32(enc, &dm.dpre, sc.dpre, 2, HID, L * sc.rows, 1, HID * 4, 0, 32, KS, 1, sw128);
  if (!err)
    err = map_f32(enc, &dm.ddir, sc.ddir, 2, HALF, sc.rows, 1, HALF * 4, 0, 32, KS, 1, sw128);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(dw_t32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DWT_SMEM_BYTES);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The pass of rays (rows) rb.. of a launch's: its pointers from there on,
// R the rays left, nt tiles (a row tile's rays have no depths).
inline Rays pass_rays(Rays rays, long long rb, int nt, long long E) {
  rays.o += 3 * rb;
  rays.d += 3 * rb;
  rays.emb += E * rb;
  if (rays.t != nullptr) rays.t += rb;
  if (rays.z != nullptr) rays.z += rays.s * rb;
  rays.R -= rb;
  rays.n_tiles = nt;
  return rays;
}

// Launch the gate pass of KIND over a pass's rays (tile c's records at
// virtual tile c vt of gates), on at most the blocks that fit at once.
template <int KIND>
inline int launch_gates(const BwdT32Call& c, const Rays& rp, uint4* gates, int vt,
                        cudaStream_t stream) {
  unsigned grid = 0;
  const int err = f32::launch_setup(gate_pass32<KIND>, c.tiles_pass, &grid);
  if (err) return err;
  const f32::Rays32 gr{rp.o, rp.d, rp.emb, rp.t, rp.z, rp.R, rp.n_tiles, rp.s, rp.rpc};
  const unsigned nt = (unsigned)rp.n_tiles;
  gate_pass32<KIND><<<grid < nt ? grid : nt, f32::THREADS, f32::SMEM_BYTES, stream>>>(
      c.P, c.wt, gr, gates, vt);
  return (int)cudaGetLastError();
}

// Run the passes of K3, K4, K6, K7 or K8 on bwd_tile32<Comp>: the tensor
// maps, then for each slice of at most tiles_pass tiles, clear its row
// sums, launch the gate pass and the tile kernel (on a persistent grid)
// with the rays' pointers from the slice's first ray on, then passes 2 and
// 3.  rays: the launch's (R its rays, s the samples a tile row, rpc rays a
// tile; K8: R rows, s = 1, rpc = 128).
template <class Comp>
inline int run_bwd_t32(const BwdT32Call& c, const Comp& comp, Rays rays, float* gmats,
                       float* gvecs, float* loss, float* demb, int n_vecs, cudaStream_t stream) {
  constexpr int KIND = Comp::ROWS ? ROW_TILE : RAYS;
  const ScratchT32& sc = c.sc;
  BwdMapsT32 maps{};
  DwMapsT32 dm{};
  int n_sm = 0;
  int err = t32_maps(c, &maps, &dm, &n_sm);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(bwd_tile32<Comp>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)T32_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    e = cudaMemsetAsync(sc.part, 0, sizeof(float) * SLOTS * nt * sc.nv, stream);
    if (e != cudaSuccess) return (int)e;
    const long long rb = t0 * c.rpc;
    const Rays rp = pass_rays(rays, rb, nt, c.P.emb_dim);
    if ((err = launch_gates<KIND>(c, rp, sc.gates, 1, stream))) return err;
    const int grid = nt < n_sm ? nt : n_sm;
    bwd_tile32<Comp><<<grid, THREADS, T32_SMEM_BYTES, stream>>>(maps, c.P, c.w, sc, rp, rb, comp,
                                                                demb);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if ((err = finish_t32(c, dm, nt, gmats, gvecs, loss, n_vecs, stream))) return err;
  }
  return 0;
}

}  // namespace tf32
}  // namespace danerf

// Bytes of stash K3, K4, K6, K7 or K8 in f32 needs for R rays of s samples
// a tile row (K3, K7: S; K4, K6: Sf) or R rows (K8: s = ROW_TILES);
// negative on a malformed layout or a shape they do not take.
extern "C" long long danerf_bwd_tf32_scratch_bytes(const long long* meta, long long n_meta,
                                                   long long R, long long s, long long n_vecs) {
  using namespace danerf;
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  const int units = tf32::tile_units_t32(s, s == ROW_TILES);
  if (units == 0 || R < 0) return ERR_SHAPE;
  return tf32::stash_t32_bytes(P, R, units, 1, n_vecs);
}

// The dynamic shared memory of a CTA of the tile kernel, of the dW pass and
// of the gate pass (ptxas -v reports only static shared memory).
extern "C" long long danerf_bwd_tf32_tile_smem_bytes() {
  return (long long)danerf::tf32::T32_SMEM_BYTES;
}
extern "C" long long danerf_bwd_tf32_dw_smem_bytes() {
  return (long long)danerf::tf32::DWT_SMEM_BYTES;
}
extern "C" long long danerf_bwd_tf32_gate_smem_bytes() {
  return (long long)danerf::f32::SMEM_BYTES;
}
