// K1 in f32 (use_bf16=False): the NeRF-W field on flat points -- encode +
// trunk + heads per tile of 128 independent rows, each with its own point,
// direction and embedding, every trunk and dir-layer product by 3xTF32 on
// the tensor cores.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _fwd_kernel (reached via
// _fused_fwd_call's pallas_call) under cfg.use_bf16 = False, and its
// has_time variant.
//
// Bound on an H100: operations.  531,968 MACs a row (the appearance
// projection, 4,096 MACs, is per row here), the trunk and dir-layer ones
// three TF32 products each (3xTF32): 0.838 ms at the 131,072 rows of a
// 1024-ray fine evaluation at TF32's 494.7 TFLOP/s (2.08 ms on the CUDA
// cores at FP32's 67), against 168 bytes a row of HBM traffic (~7 us); the
// weights' hi and lo stream from L2 once a 128-row tile.
//
// Design: field_f32_sm90.cuh's tile (persistent CTAs, a TMA ring of the
// host-split weights, two consumer warpgroups on wgmma .tf32), as K2 and K5
// run it, on row tiles (ROW_TILE, as K8's forward): the encoders load each
// tile's points, directions and times (load_row_tiles), the consumers
// encode them at z = 0 (y = 2^i x) and form each row's appearance term as
// an f32 FMA chain in the dir layer's epilogue (row_app4), then write the
// tile's rgb and sigma to the row outputs; a ragged last tile is masked,
// not padded by the caller.  The rows take one input buffer, not two: a
// second would change Smem32, which the backward tile's shared memory
// (field_bwd_f32_sm90.cuh SmemT32, 920 bytes free) holds.  One launch a
// call.
//
//   in : x, d (N,3), emb (N,E; E % 4 == 0, 16-byte aligned) f32 [, t (N)
//        with use_time]; the packed weights in f32 and split (hi, lo:
//        PackedParams.mats_tf32)
//   out: rgb (N,3), sigma (N) f32

#include <climits>

#include "field_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_f32_kernel(const __grid_constant__ SplitMaps maps, const FieldArgs P,
                   const float* __restrict__ W, const Rays rows, float* __restrict__ rgb,
                   float* __restrict__ sigma) {
  Smem32& sm = smem32();
  init32(sm);
  if (threadIdx.x >= CONSUMERS) {
    produce<ROW_TILE>(maps, P, W, rows);
    return;
  }
  consumer_regs();
  const int tiles = my_tiles(rows.n_tiles);
  Pipe pp;
  float fa[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long row0 = (blockIdx.x + (long long)c * gridDim.x) * ROWS;
    field_tile<ROW_TILE>(P, W, sm, c, 1, ROWS, pp, fa, NoResStash(),
                         rows.emb + row0 * P.emb_dim);
    const int n = (int)(rows.R - row0 < ROWS ? rows.R - row0 : ROWS);
    for (int i = threadIdx.x; i < 3 * n; i += CONSUMERS) rgb[row0 * 3 + i] = sm.rgb[i];
    for (int i = threadIdx.x; i < n; i += CONSUMERS) sigma[row0 + i] = sm.sigma[i];
    end_tile<ROW_TILE>(sm, c);
  }
}

extern "C" int danerf_mlp_fwd_f32(const float* x, const float* d, const float* emb,
                                  const float* t, long long N, long long E, float* rgb,
                                  float* sigma, const float* mats, const float* w_hi,
                                  const float* w_lo, const float* vecs, const long long* meta,
                                  long long n_meta, void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, vecs, E, &P);
  if (err) return err;
  // row_app4 reads emb and Wapp 16 bytes at a time; row coordinates are
  // 32-bit
  if (P.emb_dim % 4 || reinterpret_cast<uintptr_t>(emb) % 16 || N < 0 || check_time(P, t))
    return ERR_SHAPE;
  const long long n_tiles = (N + ROWS - 1) / ROWS;
  if (n_tiles * ROWS > INT_MAX) return ERR_SHAPE;
  if (N == 0) return 0;
  SplitMaps maps;
  unsigned grid = 0;
  const int e = launch_setup(mlp_fwd_f32_kernel, P, w_hi, w_lo, n_tiles, &maps, &grid);
  if (e) return e;
  const Rays rows{x, d, emb, t, nullptr, nullptr, nullptr, N, n_tiles, 1, ROWS, 0};
  mlp_fwd_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, P, mats, rows, rgb, sigma);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a CTA takes (ptxas -v reports only static
// shared memory).
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::tf32::SMEM_BYTES; }
