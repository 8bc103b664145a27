// K1: the NeRF-W field on flat points -- encode + trunk + heads per tile of
// 128 independent rows, each with its own point, direction and embedding.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _fwd_kernel (reached via
// _fused_fwd_call's pallas_call), the forward of fused_nerf_apply.
//
// Bound on an H100: operations.  531,968 MACs a row (the appearance
// projection, 4,096 MACs, is per row here), so 131,072 rows (the fine pass
// of a 1024-ray batch at 128 samples) are ~0.14 TFLOP, 0.141 ms at 989
// TFLOP/s bf16 dense, against 168 bytes a row of HBM traffic (~7 us).
//
// Design: field_sm90.cuh's Hopper tile, as K2 and K5 run it (persistent
// CTAs of 3 warpgroups, the weights streamed by TMA through a 3-stage ring,
// two consumer warpgroups on wgmma with the activations in place in shared
// memory, the encoders one tile ahead), with a tile of 128 independent rows
// (ROW_TILE): the encoders load each tile's points, directions and times
// into shared memory, encode them, and stash the rows' bf16 embeddings in
// the wrapper's scratch (rows x E bf16, written once and read back once
// from L2); the producer loads Wapp and those embeddings into one ring
// stage after the dir layer's, and emb @ Wapp^T is one wgmma (m64n128,
// K = E) into the accumulators beside the dir layer's, added after its relu
// in f32 (the JAX order).  The consumers write each tile's rgb and sigma to
// the row outputs; a ragged last tile is masked, not padded by the caller.
// One launch a call.
//
//   in : x, d (N,3), emb (N,E) f32 [, t (N) with use_time]
//   out: rgb (N,3), sigma (N) f32
//   scratch: the rows' bf16 embeddings, n_tiles x 128 x E bf16

#include <climits>

#include "field_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

// The weight maps and K1's two: Wapp and the stash of the rows' embeddings.
struct __align__(64) RowMaps {
  WeightMaps w;
  CUtensorMap wapp, embr;
};

__global__ void __launch_bounds__(THREADS90, 1)
mlp_fwd_kernel(const __grid_constant__ RowMaps maps, const FieldArgs P, const Rays rows,
               __nv_bfloat16* __restrict__ stash, float* __restrict__ rgb,
               float* __restrict__ sigma) {
  Smem90& sm = smem90();
  init_ring(sm);
  if (is_producer()) {
    produce<ROW_TILE>(maps.w, P, rows, RowApp{&maps.wapp, &maps.embr, stash});
    return;
  }
  consumer_regs();
  const int tiles = my_tiles(rows.n_tiles);
  Pipe pp;
  float fa[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long row0 = (blockIdx.x + (long long)c * gridDim.x) * ROWS;
    field_tile90<ROW_TILE>(P, sm, c, 1, ROWS, pp, fa);
    const int n = (int)(rows.R - row0 < ROWS ? rows.R - row0 : ROWS);
    for (int i = threadIdx.x; i < 3 * n; i += CONSUMERS) rgb[row0 * 3 + i] = sm.rgb[i];
    for (int i = threadIdx.x; i < n; i += CONSUMERS) sigma[row0 + i] = sm.sigma[i];
    end_tile(sm, c);
  }
}

// The scratch bytes K1 takes for N rows of E-wide embeddings.
extern "C" long long danerf_mlp_fwd_scratch_bytes(long long N, long long E) {
  return (N + ROWS - 1) / ROWS * ROWS * E * (long long)sizeof(__nv_bfloat16);
}

extern "C" int danerf_mlp_fwd(const float* x, const float* d, const float* emb, const float* t,
                              long long N, long long E, float* rgb, float* sigma,
                              const void* mats, const float* vecs, const long long* meta,
                              long long n_meta, void* scratch, long long scratch_bytes,
                              void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, mats, vecs, E, &P);
  if (err) return err;
  // emb @ Wapp^T steps K by 16, the stash reads emb 16 bytes at a time; TMA
  // row coordinates are 32-bit
  if (P.emb_dim % 16 || reinterpret_cast<uintptr_t>(emb) % 16 || N < 0 || check_time(P, t))
    return ERR_SHAPE;
  const long long n_tiles = (N + ROWS - 1) / ROWS;
  if (n_tiles * ROWS > INT_MAX || scratch_bytes < danerf_mlp_fwd_scratch_bytes(N, E))
    return ERR_SHAPE;
  if (N == 0) return 0;
  RowMaps maps;
  unsigned grid = 0;
  int e = launch_setup(mlp_fwd_kernel, P, n_tiles, &maps.w, &grid);
  if (e) return e;
  const EncodeTiledFn enc = encode_tiled();
  e = weight_map(enc, &maps.wapp, P.mats + P.wapp_off, P.emb_dim, HALF);
  if (!e) e = map2d(enc, &maps.embr, scratch, P.emb_dim, n_tiles * ROWS, KS, ROWS);
  if (e) return e;
  auto* stash = static_cast<__nv_bfloat16*>(scratch);
  const Rays rows{x, d, emb, t, nullptr, nullptr, nullptr, N, n_tiles, 1, ROWS, 0};
  mlp_fwd_kernel<<<grid, THREADS90, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, P, rows, stash, rgb, sigma);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a CTA takes (ptxas -v reports only static
// shared memory).
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::sm90::SMEM_BYTES; }
