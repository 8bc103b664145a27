// The backward of the NeRF-W field in f32 (use_bf16=False) on the CUDA
// cores for the f32 variants of the training kernels K7
// (march_train_f32.cu), the ray march's backward under the MSE, and K6
// (merged_bwd_f32.cu), the merged fine pass's under the caller's
// cotangents; K3, K4, K8 and K9 run on field_bwd_f32_sm90.cuh's
// tensor-core tile.  The counterpart of
// danerf_tpu/kernels/fused_mlp.py _field_bwd_from_res with cdt = float32,
// as the JAX kernels run it when cfg.use_bf16 is off.  The composites,
// demb, the dW pass and the row sums come from bwd_f32_parts.cuh.
//
// Numerics: the JAX f32 configuration's.  Every residual is stashed in f32,
// every product is an f32 FFMA on the CUDA cores, every sum is an f32 sum;
// nothing rounds to bf16 or TF32.  Only the order of the sums differs from
// the plain version's.  The relu gate of a trunk layer is its stashed output
// > 0 (relu(pre) > 0 exactly where pre > 0), the dir layer's its stashed
// relu(hdir_pre) > 0, so no bit mask is kept.  Every sum runs in a fixed
// order and nothing is added atomically, so two calls give bit-identical
// results.
//
// Tile kernel (bwd32_tile, one block an SM, 256 threads): for each tile of
// rpc rays of s samples (field.cuh's shapes: rpc = min(128 / s, 8)),
// - Forward with residuals: field_f32.cuh's field_block on each 64-row block
//   of the tile (FFMA, 8 x 8 accumulators a thread, 32-deep K slices
//   streamed by cp.async through two stages, activations column-major at
//   pitch AP), its StashRes hook writing each trunk layer's output, happ and
//   relu(hdir_pre) to the f32 stash and keeping sigma_pre; StashEnc writes
//   the encodings and each row's embedding.  A block past the tile's rows
//   writes zeros to its stash rows instead.
// - Composite: one warp per ray (field_bwd.cuh composite_keep /
//   composite_bwd, bwd_tiles.cuh ray_cotangents); K4 and K6 merge by rank
//   (field.cuh merge_ray) and un-permute by the ranks (merge_ranks).  Its
//   arrays live in the weight stages, idle between the forward and the
//   chain.
// - Chain head, per 64-row block: d_pre_rgb, d_sigma_pre, the rgb and
//   density heads' row sums, d_happ = d_pre_rgb @ Wrgb and d_hdir_pre, in
//   f32, each stashed; d_hdir_pre into the activation buffer as the first
//   product's A; each ray's sum of d_happ over its rows (demb after the
//   tile's blocks: that sum @ Wapp).
// - Transposed chain: d_in = d_pre @ W[:, :HID] on the forward's FFMA
//   slice (ffma_slice), A = the activation buffer, B = W's own rows: in
//   f32, PackedParams.mats holds W (out, K) row-major, so a 32-deep slice
//   of the reduction index (out) is 32 rows of HID contiguous floats at the
//   layer's pitch (ChainStream; no transposed copy).  Each d_pre is gated
//   by the stashed output of its layer, written back in place and stashed;
//   its bias sums go to the block's slot of the tile's row sums (2 slots a
//   tile, summed in slot order by sum_slots32).
// Shared memory: field_f32.cuh's Smem (187,616 bytes), sigma_pre and
// field_bwd.cuh's BwdSmem: 198,400 of 232,448 bytes.
//
// dW pass (dw32_kernel): dW = d_pre^T @ input over every stashed row, one
// 64 x 64 output tile of one job a block over one of `parts` fixed row
// partitions (32-row slabs, 4 x 4 outputs a thread), the partitions summed
// in order (dw32_reduce).  Jobs: every trunk layer (A = d_pre_i, B = its
// input: h_{i-1}, and for layer 0 and the skips enc_x), the dir layer
// ([h_{L-1}, enc_d]), the appearance projection (the embeddings) and the
// rgb head (happ).
//
// Residuals: ~18 KB a row in f32 (twice the bf16 tile's ~9.5 KB): 8 trunk
// outputs and 8 d_pre of 256 floats, the encodings, happ, d_happ,
// d_hdir_pre, d_pre_rgb and the embedding.  A pass holds at most
// MAX_TILES_PASS32 tiles, half the bf16 tile's, so the stash stays at
// ~2.4 GB (131,072 rows), as the bf16 stash of a full pass; ~1.2 GB at a
// 1024-ray batch of 64 samples.

#pragma once

#include <stddef.h>

#include "field_f32.cuh"
#include "bwd_f32_parts.cuh"

namespace danerf {
namespace f32 {


// One pass's stash, rows = tiles * TILE_M, row-major f32; the row sums (2
// slots a tile x nv, the vecs layout and the loss) and the dW pass's
// partial tiles.
struct Scratch32 {
  float* h;       // L x rows x HID: trunk layer outputs
  float* dpre;    // L x rows x HID: d_pre of each trunk layer
  float* encx;    // rows x kx
  float* encd;    // rows x kd
  float* happ;    // rows x HALF
  float* dapp;    // rows x HALF: d_happ
  float* ddir;    // rows x HALF: relu(hdir_pre) from the forward, d_hdir_pre from the chain head
  float* drgb;    // rows x DRGB32: d_pre_rgb
  float* embr;    // rows x E: the embedding of the row's ray
  float* part;    // 2 slots a tile x nv
  float* dwpart;  // DW32_PARTS x dw_tiles x 64 x 64
  long long rows;
  int nv, dw_tiles;
};

struct SmemB32 {
  Smem f;                   // the forward's tile; f.w holds the composite's arrays
  float sigma_pre[TILE_M];  // the tile's rows
  BwdSmem bs;               // cotangents, d_pre_rgb, d_sigma_pre, each ray's d_happ sums, loss
};
constexpr size_t BWD32_SMEM_BYTES = sizeof(SmemB32);
static_assert(BWD32_SMEM_BYTES <= 232448, "the f32 backward tile exceeds the 227 KB a block may use");
// The composite's arrays of every shape the march (K3, K7) and merged (K4,
// K6) kernels take (bwd_smem_bytes / merged_smem_bytes <= 232,448 beside
// field.cuh's SHAPE_TILE_BYTES) fit in the weight stages.
static_assert(232448 - SHAPE_TILE_BYTES - sizeof(BwdSmem) <= sizeof(Smem::w),
              "the composite's arrays must fit in the weight stages");
// The chain's spare buffer (the encodings', idle once they are stashed):
// one block's d_happ, then the column sums of each warp.
constexpr int SPARE = (int)((offsetof(Smem, rgb) - offsetof(Smem, encx)) / sizeof(float));
static_assert(SPARE >= MB * HALF && SPARE >= (THREADS / 32) * HID, "the spare buffer is too small");

static_assert(THREADS == COMP_THREADS && THREADS == DW32_THREADS,
              "bwd_f32_parts.cuh's composites and dW pass run on this tile's threads");

__device__ __forceinline__ SmemB32& smem_b32() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<SmemB32*>(smem_raw);
}

__device__ __forceinline__ float* spare(Smem& sm) { return sm.encx; }

__device__ __forceinline__ void fill0(float* p, long long n) {
  for (long long i = threadIdx.x; i < n; i += THREADS) p[i] = 0.f;
}

// ---------------------------------------------------------------- forward

// The encoder of a block's rows (field_f32.cuh RayEnc) that also writes the
// encodings and each row's embedding to the stash rows g0..
template <class Enc>
struct StashEnc {
  Enc enc;
  float* encx;
  float* encd;
  float* embr;
  long long g0;

  __device__ __forceinline__ void put(const float* src, int width, float* dst) const {
    for (int i = threadIdx.x; i < MB * width; i += THREADS) {
      const int r = i / width, c = i - r * width;
      dst[(g0 + r) * width + c] = src[c * AP + r];
    }
  }
  __device__ __forceinline__ void operator()(Smem& sm) const {
    enc(sm);
    __syncthreads();
    put(sm.encx, enc.P.kx, encx);
    put(sm.encd, enc.P.kd, encd);
    put(sm.emb, enc.P.emb_dim, embr);
  }
};

// field_block's stash hook: each trunk layer's output, relu(hdir_pre) (in
// ddir's place) and happ to the stash rows g0.., sigma_pre to the tile's
// shared array at sp.
struct StashRes {
  float* h;
  float* ddir;
  float* happ;
  float* sp;
  long long rows, g0;

  __device__ __forceinline__ void trunk(int m, int c, int w8, const float (&v)[8]) const {
    float* p = h + ((long long)m * rows + g0 + w8) * HID + c;
#pragma unroll
    for (int r = 0; r < 8; ++r) p[r * HID] = v[r];
  }
  __device__ __forceinline__ void sigma_pre(int row, float v) const { sp[row] = v; }
  __device__ __forceinline__ void head(int row, int c, float hdir, float ha) const {
    ddir[(g0 + row) * HALF + c] = hdir;
    happ[(g0 + row) * HALF + c] = ha;
  }
};

// Zeros in every stash array at the MB rows g0.. (a block past the tile's
// rows, which the dW pass still reads).
__device__ __forceinline__ void zero_rows(const FieldArgs& P, const Scratch32& sc, long long g0) {
  for (int m = 0; m < P.num_layers; ++m) {
    fill0(sc.h + ((long long)m * sc.rows + g0) * HID, (long long)MB * HID);
    fill0(sc.dpre + ((long long)m * sc.rows + g0) * HID, (long long)MB * HID);
  }
  fill0(sc.encx + g0 * P.kx, (long long)MB * P.kx);
  fill0(sc.encd + g0 * P.kd, (long long)MB * P.kd);
  fill0(sc.happ + g0 * HALF, (long long)MB * HALF);
  fill0(sc.dapp + g0 * HALF, (long long)MB * HALF);
  fill0(sc.ddir + g0 * HALF, (long long)MB * HALF);
  fill0(sc.drgb + g0 * DRGB32, (long long)MB * DRGB32);
  fill0(sc.embr + g0 * P.emb_dim, (long long)MB * P.emb_dim);
}

// ---------------------------------------------------------------- chain

// A matrix of the transposed chain: kr rows of the reduction index (its
// outputs), each of HID contiguous floats at pitch ld.
struct ChainMat {
  const float* w;
  int kr, ld;
};

// The transposed chain's weight stream: step q's matrix is the dir layer's
// (q = 0, K = HALF) or trunk layer L - q's (K = HID), W (out, K) row-major in
// w at its packed offset; slice (q, k0) lands in stage n & 1 for the n-th
// slice; load() starts the next one's copy.
struct ChainStream {
  const FieldArgs& P;
  const float* w;
  Smem& sm;
  int q = 0, k0 = 0, n = 0;

  __device__ __forceinline__ ChainMat mat(int qq) const {
    if (qq == 0) return {w + P.wdir_off, HALF, HID + P.kd};
    const int i = P.num_layers - qq;
    return {w + P.w_off[i], HID, ((P.skip_mask >> i) & 1) ? HID + P.kx : HID};
  }
  __device__ __forceinline__ void load() {
    if (q >= P.num_layers) return;
    const ChainMat mt = mat(q);
    float4* dst = reinterpret_cast<float4*>(sm.w[n & 1]);
    for (int i = threadIdx.x; i < KSF * HID / 4; i += THREADS) {
      const int row = i / (HID / 4), c4 = i - row * (HID / 4);
      cp_async16(dst + i, mt.w + (long long)(k0 + row) * mt.ld + 4 * c4);
    }
    cp_async_commit();
    ++n;
    k0 += KSF;
    if (k0 >= mt.kr) {
      ++q;
      k0 = 0;
    }
  }
};

// acc = d_pre @ W[:, :HID] of step q for the thread's 8 rows and 8 columns
// (lane + 32 j), A = sm.act (column-major, K = HALF at the dir step, else
// HID), as mma_mat paces its stream.
__device__ __forceinline__ void mma_chain(float (&acc)[8][8], ChainStream& st, int q) {
  const int w8 = (threadIdx.x >> 5) * 8, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  const int K = q == 0 ? HALF : HID;
  for (int k0 = 0; k0 < K; k0 += KSF) {
    const int stage = (st.n - 1) & 1;
    cp_async_wait_all();
    __syncthreads();
    st.load();
    ffma_slice<8>(acc, st.sm.act + k0 * AP + w8, st.sm.w[stage] + lane, KSF);
  }
}

// The chain's head on the block of MB rows at tile row rb (stash rows
// g0..): d_pre_rgb and d_sigma_pre of each row, the rgb and density heads'
// row sums and wd's (over the stashed last trunk output) into the block's
// slot `part`; d_happ = d_pre_rgb @ Wrgb and d_hdir_pre = (relu(hdir_pre) >
// 0) ? d_happ : 0, stashed, d_hdir_pre into sm.act (the first product's
// A), the bapp / bdir row sums; each of the tile's nvalid rays (s rows
// each) adds its rows' d_happ to bs.dsum.
__device__ __forceinline__ void chain_head(const FieldArgs& P, const float* w, SmemB32& sb,
                                           const Scratch32& sc, long long g0, int rb, int s,
                                           int nvalid, float* part) {
  Smem& sm = sb.f;
  BwdSmem& bs = sb.bs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = tid; r < MB; r += THREADS) {
    const int row = rb + r;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float y = sm.rgb[row * 3 + c];
      v[c] = bs.g_rgb[row * 3 + c] * y * (1.f - y);
      bs.dpr[row * 3 + c] = v[c];
    }
    *reinterpret_cast<float4*>(sc.drgb + (g0 + r) * DRGB32) = make_float4(v[0], v[1], v[2], 0.f);
    const float sp = sb.sigma_pre[row];
    const float act = P.softplus ? 1.f / (1.f + expf(-sp)) : (sp > 0.f ? 1.f : 0.f);
    bs.dsp[row] = bs.g_sig[row] * act;
  }
  __syncthreads();
  if (warp == 0) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, ad = 0.f;
    for (int r = rb + lane; r < rb + MB; r += 32) {
      a0 += bs.dpr[r * 3 + 0];
      a1 += bs.dpr[r * 3 + 1];
      a2 += bs.dpr[r * 3 + 2];
      ad += bs.dsp[r];
    }
    a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2); ad = warp_sum(ad);
    if (lane == 0) {
      part[P.brgb_off + 0] = a0; part[P.brgb_off + 1] = a1; part[P.brgb_off + 2] = a2;
      part[P.bd_off] = ad;
    }
  }
  {
    const float* h = sc.h + ((long long)(P.num_layers - 1) * sc.rows + g0) * HID + tid;
    float a = 0.f;  // HID == THREADS: a column a thread
    for (int r = 0; r < MB; ++r) a += h[(long long)r * HID] * bs.dsp[rb + r];
    part[P.wd_off + tid] = a;
  }
  float* dap = spare(sm);  // MB x HALF
  const float* wrgb = w + P.wrgb_off;  // (3, HALF)
  for (int idx = tid; idx < MB * HALF; idx += THREADS) {
    const int r = idx / HALF, c = idx - r * HALF, row = rb + r;
    const float dh = bs.dpr[row * 3 + 0] * wrgb[c] + bs.dpr[row * 3 + 1] * wrgb[HALF + c] +
                     bs.dpr[row * 3 + 2] * wrgb[2 * HALF + c];
    const long long at = (g0 + r) * HALF + c;
    const float dd = sc.ddir[at] > 0.f ? dh : 0.f;
    sc.dapp[at] = dh;
    sc.ddir[at] = dd;
    dap[idx] = dh;
    sm.act[c * AP + r] = dd;
  }
  __syncthreads();
  {
    const int c = tid & (HALF - 1);
    float a = 0.f;
    if (tid < HALF) {
      for (int r = 0; r < MB; ++r) a += dap[r * HALF + c];
      part[P.bapp_off + c] = a;
    } else {
      for (int r = 0; r < MB; ++r) a += sm.act[c * AP + r];
      part[P.bdir_off + c] = a;
    }
  }
  const int j0 = rb / s, j1 = min(nvalid, (rb + MB + s - 1) / s);
  for (int idx = tid; idx < (j1 - j0) * HALF; idx += THREADS) {
    const int j = j0 + idx / HALF, c = idx % HALF;
    const int r0 = max(j * s, rb) - rb, r1 = min((j + 1) * s, rb + MB) - rb;
    float a = 0.f;
    for (int r = r0; r < r1; ++r) a += dap[r * HALF + c];
    bs.dsum[j * HALF + c] += a;
  }
}

// A transposed product's epilogue: d_pre_i = (h_i > 0) ? acc (+ d_sigma_pre
// wd at the dir step) : 0 for the block's rows (tile row rb, stash rows
// g0..), into sm.act (the next product's A) and the stash; its column sums
// (bias i) to the block's slot, each warp's in the spare buffer, summed in
// warp order.
__device__ __forceinline__ void chain_epilogue(const FieldArgs& P, SmemB32& sb, const Scratch32& sc,
                                               const float (&acc)[8][8], int i, bool dir,
                                               long long g0, int rb, float* part) {
  Smem& sm = sb.f;
  const int warp = threadIdx.x >> 5, w8 = warp * 8, lane = threadIdx.x & 31;
  float* colsum = spare(sm);  // 8 x HID
  const long long at = ((long long)i * sc.rows + g0 + w8) * HID;
  const float* hin = sc.h + at;
  float* dout = sc.dpre + at;
  __syncthreads();  // every thread has read this product's A (and the spare buffer)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = lane + 32 * j;
    const float wd = dir ? __ldg(P.vecs + P.wd_off + c) : 0.f;
    float d[8], s = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v = acc[r][j];
      if (dir) v += sb.bs.dsp[rb + w8 + r] * wd;
      d[r] = hin[r * HID + c] > 0.f ? v : 0.f;
      dout[r * HID + c] = d[r];
      s += d[r];
    }
    *reinterpret_cast<float4*>(sm.act + c * AP + w8) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(sm.act + c * AP + w8 + 4) = make_float4(d[4], d[5], d[6], d[7]);
    colsum[warp * HID + c] = s;
  }
  __syncthreads();
  {
    const int c = threadIdx.x;  // HID == THREADS
    float a = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) a += colsum[w * HID + c];
    part[P.b_off[i] + c] = a;
  }
}

__device__ __forceinline__ void zero_cotangents32(BwdSmem& bs) {
  for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
    bs.g_sig[r] = 0.f;
    bs.g_rgb[r * 3 + 0] = 0.f; bs.g_rgb[r * 3 + 1] = 0.f; bs.g_rgb[r * 3 + 2] = 0.f;
  }
}

// The forward of a tile's rows (n rays of s samples, the depths in sm.z),
// its residuals to the stash rows g0.. (the blocks past its rows zeroed
// there), rgb, sigma and sigma_pre to the tile's rows, behind a barrier.
__device__ __forceinline__ void forward_set(const FieldArgs& P, const float* wt, SmemB32& sb,
                                            const Scratch32& sc, const Rays32& rays,
                                            long long ray0, int n, int s, long long g0) {
  Smem& sm = sb.f;
  const int blocks = (n * s + MB - 1) / MB;
  for (int b = 0; b < blocks; ++b) {
    const long long gb = g0 + b * MB;
    const StashRes res{sc.h, sc.ddir, sc.happ, sb.sigma_pre + b * MB, sc.rows, gb};
    field_block(P, wt, sm, StashEnc<RayEnc>{RayEnc{P, rays.emb, ray0, b * MB, s, n}, sc.encx,
                                            sc.encd, sc.embr, gb},
                sm.rgb + b * MB * 3, sm.sigma + b * MB, res);
  }
  for (int b = blocks; b < TILE_M / MB; ++b) zero_rows(P, sc, g0 + b * MB);
  __syncthreads();
}

// The chain of a tile's blocks (stash rows g0.., tile rows 0.., each ray s
// rows, nvalid rays): per block its head and the transposed chain, the
// block's row sums to slot b of part.
__device__ __forceinline__ void chain_blocks(const FieldArgs& P, const float* w, SmemB32& sb,
                                             const Scratch32& sc, long long g0, int blocks,
                                             int s, int nvalid, float* part) {
  const int L = P.num_layers;
  for (int b = 0; b < blocks; ++b) {
    ChainStream cs{P, w, sb.f};
    cs.load();  // the first slice streams in while the head runs
    chain_head(P, w, sb, sc, g0 + b * MB, b * MB, s, nvalid, part + b * sc.nv);
    for (int q = 0; q < L; ++q) {
      float acc[8][8];
      mma_chain(acc, cs, q);
      chain_epilogue(P, sb, sc, acc, L - 1 - q, q == 0, g0 + b * MB, b * MB, part + b * sc.nv);
    }
  }
}

// The tile kernel (pass 1) of K6 and K7: for each tile of rpc rays
// (ray_base + tile rpc.., stash rows tile TILE_M..), the forward with its
// residuals, the composite and its transpose (comp), then per block the
// chain's head and the transposed chain, then each ray's demb.
template <class Comp>
__global__ void __launch_bounds__(THREADS)
bwd32_tile(const FieldArgs P, const float* __restrict__ wt, const float* __restrict__ w,
           const Scratch32 sc, const Rays32 rays, long long ray_base, const Comp comp,
           float* __restrict__ demb) {
  static_assert(!Comp::ROWS, "row tiles run on field_bwd_f32_sm90.cuh");
  SmemB32& sb = smem_b32();
  Smem& sm = sb.f;
  BwdSmem& bs = sb.bs;
  const int s = rays.s, rpc = rays.rpc;
  for (long long tile = blockIdx.x; tile < rays.n_tiles; tile += gridDim.x) {
    const long long ray0 = ray_base + tile * rpc, gt = tile * TILE_M;
    const int n_rays = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    const int blocks = (n_rays * s + MB - 1) / MB;
    __syncthreads();  // every thread is done with the last tile
    load_rays(sm, rays, ray0, n_rays);
    for (int i = threadIdx.x; i < rpc * HALF; i += THREADS) bs.dsum[i] = 0.f;
    zero_cotangents32(bs);
    forward_set(P, wt, sb, sc, rays, ray0, n_rays, s, gt);
    comp(CompTile<BlockSync>{sm.z, sm.sigma, sm.rgb, bs, sm.w[0], {}}, ray0, n_rays, rpc);
    __syncthreads();
    {
      Scratch sums{};  // store_tile_loss reads part and nv only
      sums.part = sc.part;
      sums.nv = sc.nv;
      store_tile_loss<Comp::MSE>(bs, sums, (int)(2 * tile), n_rays);
    }
    chain_blocks(P, w, sb, sc, gt, blocks, s, n_rays, sc.part + 2 * tile * sc.nv);
    __syncthreads();
    ray_demb(P, w, bs, ray0, n_rays, demb);
  }
}

// ------------------------------------------------------------- pass 2: dW

// ------------------------------------------------------------------ host

// The dW jobs of a pass over `rows` stash rows (gmats: null to count the
// tiles only): every trunk layer, its enc_x part at layer 0 and the skips,
// the dir layer's [h_{L-1}, enc_d], the appearance projection, the rgb head.
inline int dw32_jobs(const FieldArgs& P, const Scratch32& sc, float* gmats, long long rows,
                     Dw32Jobs* J) {
  J->n = 0;
  J->rows = rows;
  const long long ls = sc.rows * HID;
  const int L = P.num_layers, kx = P.kx, kd = P.kd, E = P.emb_dim;
  auto at = [&](long long off) { return gmats == nullptr ? nullptr : gmats + off; };
  int n = 0;
  add_job32(*J, n, sc.dpre, HID, HID, HID, sc.encx, kx, kx, at(P.w_off[0]), kx);
  for (int i = 1; i < L; ++i) {
    const bool skip = (P.skip_mask >> i) & 1;
    const int ld = skip ? HID + kx : HID;
    add_job32(*J, n, sc.dpre + i * ls, HID, HID, HID, sc.h + (i - 1) * ls, HID, HID,
              at(P.w_off[i]), ld);
    if (skip)
      add_job32(*J, n, sc.dpre + i * ls, HID, HID, HID, sc.encx, kx, kx, at(P.w_off[i] + HID), ld);
  }
  add_job32(*J, n, sc.ddir, HALF, HALF, HALF, sc.h + (L - 1) * ls, HID, HID, at(P.wdir_off),
            HID + kd);
  add_job32(*J, n, sc.ddir, HALF, HALF, HALF, sc.encd, kd, kd, at(P.wdir_off + HID), HID + kd);
  add_job32(*J, n, sc.dapp, HALF, HALF, HALF, sc.embr, E, E, at(P.wapp_off), E);
  add_job32(*J, n, sc.drgb, DRGB32, DRGB32, 3, sc.happ, HALF, HALF, at(P.wrgb_off), HALF);
  return n;
}

// Lay the stash out from base (or only measure it, base == nullptr) for
// `tiles` tiles of rows; returns its size in bytes.
inline long long carve32(char* base, const FieldArgs& P, long long tiles, int n_vecs,
                         Scratch32* s) {
  const long long rows = tiles * TILE_M;
  long long off = 0;
  auto take = [&](long long floats) -> float* {
    float* p = base ? reinterpret_cast<float*>(base + off) : nullptr;
    off += (floats * (long long)sizeof(float) + 1023) / 1024 * 1024;
    return p;
  };
  const int L = P.num_layers;
  s->h = take(L * rows * HID);
  s->dpre = take(L * rows * HID);
  s->encx = take(rows * P.kx);
  s->encd = take(rows * P.kd);
  s->happ = take(rows * HALF);
  s->dapp = take(rows * HALF);
  s->ddir = take(rows * HALF);
  s->drgb = take(rows * DRGB32);
  s->embr = take(rows * P.emb_dim);
  s->nv = n_vecs + 1;
  s->part = take(2 * tiles * s->nv);
  s->rows = rows;
  Dw32Jobs J;
  s->dw_tiles = dw32_jobs(P, *s, nullptr, rows, &J);
  s->dwpart = take((long long)DW32_PARTS * s->dw_tiles * DW32_TILE * DW32_TILE);
  return off;
}

// What the kernels on this tile set up: the layout records (meta_t: where
// the chain's blocks lie in w, f32 W (out, K) at the packed offsets: -1,
// w_off[1..L-1], wdir_off, wapp_off), the shape checks (the backward
// kernels' widths, 1..128 samples a tile row), the stash of one pass and
// the pass sizes, for R rays of s samples in a tile's rows (K7: S; K6: Sf).
struct Bwd32Call {
  FieldArgs P;
  const float* wt;  // the forward's weights, transposed (mats_kn)
  const float* w;   // the weights (out, K) f32 (PackedParams.mats)
  Scratch32 sc;
  int rpc, tiles_pass;
  long long tiles_total;
};

// The stash bytes of one pass over R rays of s samples a tile row.
inline long long scratch32_bytes(const FieldArgs& P, long long R, long long s,
                                 long long n_vecs) {
  long long tiles = (R + rays_per_tile(s) - 1) / rays_per_tile(s);
  if (tiles > MAX_TILES_PASS32) tiles = MAX_TILES_PASS32;
  Scratch32 sc;
  return carve32(nullptr, P, tiles, (int)n_vecs, &sc);
}

inline int bwd32_setup(const long long* meta, long long n_meta, const void* wt,
                       const float* vecs, long long E, const void* w, const long long* meta_t,
                       long long n_meta_t, long long R, long long s, void* scratch,
                       long long scratch_bytes, long long n_vecs, Bwd32Call* c) {
  int err = parse_meta(meta, n_meta, nullptr, vecs, E, &c->P);
  if (err) return err;
  const FieldArgs& P = c->P;
  const int L = P.num_layers;
  if (n_meta_t != L + 2 || meta_t[L] != P.wdir_off || meta_t[L + 1] != P.wapp_off) return ERR_META;
  for (int i = 1; i < L; ++i)
    if (meta_t[i] != P.w_off[i]) return ERR_META;
  if (P.emb_dim % 4 || 2 * L + 4 > MAX_JOBS32 || n_vecs < 1 || s < 1 || s > TILE_M || R < 0)
    return ERR_SHAPE;
  c->wt = static_cast<const float*>(wt);
  c->w = static_cast<const float*>(w);
  c->rpc = rays_per_tile(s);
  c->tiles_total = (R + c->rpc - 1) / c->rpc;
  c->tiles_pass = (int)(c->tiles_total < MAX_TILES_PASS32 ? c->tiles_total : MAX_TILES_PASS32);
  if (carve32(static_cast<char*>(scratch), P, c->tiles_pass, (int)n_vecs, &c->sc) >
      scratch_bytes)
    return ERR_SHAPE;
  return 0;
}

// Passes 2 and 3 for the nt tiles of one pass: the dW jobs over
// fixed row partitions, their sum in partition order, the row sums (2
// slots a tile; loss null: the loss column is not summed).
inline int finish32(const Bwd32Call& c, int nt, float* gmats, float* gvecs, float* loss,
                    int n_vecs, cudaStream_t stream) {
  const Scratch32& sc = c.sc;
  const long long rows = (long long)nt * TILE_M;
  Dw32Jobs J;
  const int n = dw32_jobs(c.P, sc, gmats, rows, &J);
  if (n != sc.dw_tiles) return ERR_META;
  long long parts = rows / DW32_PART_ROWS;
  parts = parts < 1 ? 1 : (parts > DW32_PARTS ? DW32_PARTS : parts);
  dw32_kernel<<<dim3(n, (unsigned)parts), DW32_THREADS, 0, stream>>>(J, sc.dwpart, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_el = (long long)n * DW32_TILE * DW32_TILE;
  dw32_reduce<<<(unsigned)((n_el + 255) / 256), 256, 0, stream>>>(J, sc.dwpart, n, (int)parts);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_slots32<<<(sc.nv + 31) / 32, 256, 0, stream>>>(sc.part, 2 * nt, sc.nv, n_vecs, gvecs, loss);
  return (int)cudaGetLastError();
}

// Run the passes of K6 or K7 on bwd32_tile<Comp>: for each slice of
// at most tiles_pass tiles, clear its row sums, launch the tile kernel on
// the blocks that fit on the card at once, then passes 2 and 3.
template <class Comp>
inline int run_bwd32(const Bwd32Call& c, const Comp& comp, Rays32 rays, float* gmats,
                     float* gvecs, float* loss, float* demb, int n_vecs, cudaStream_t stream) {
  const Scratch32& sc = c.sc;
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    cudaError_t e = cudaMemsetAsync(sc.part, 0, sizeof(float) * 2 * nt * sc.nv, stream);
    if (e != cudaSuccess) return (int)e;
    unsigned grid = 0;
    const int err = launch_setup(bwd32_tile<Comp>, nt, &grid, BWD32_SMEM_BYTES);
    if (err) return err;
    rays.n_tiles = nt;
    bwd32_tile<Comp><<<grid, THREADS, BWD32_SMEM_BYTES, stream>>>(c.P, c.wt, c.w, sc, rays,
                                                                   t0 * c.rpc, comp, demb);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int ferr = finish32(c, nt, gmats, gvecs, loss, n_vecs, stream);
    if (ferr) return ferr;
  }
  return 0;
}

}  // namespace f32
}  // namespace danerf

// Bytes of stash K6 or K7 in f32 needs for R rays of s samples a tile row
// group (K7: S; K6: Sf); negative on a malformed layout or a shape they do
// not take.
extern "C" long long danerf_bwd_f32_scratch_bytes(const long long* meta, long long n_meta,
                                                  long long R, long long s, long long n_vecs) {
  using namespace danerf;
  using namespace danerf::f32;
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  if (s < 1 || s > TILE_M || R < 0) return ERR_SHAPE;
  return scratch32_bytes(P, R, s, n_vecs);
}

// The dynamic shared memory of a block of the tile kernel (ptxas -v
// reports only static shared memory).
extern "C" long long danerf_bwd_tile_smem_bytes() {
  return (long long)danerf::f32::BWD32_SMEM_BYTES;
}
