// K1 in f32 (use_bf16=False): the NeRF-W field on flat points -- encode +
// trunk + heads per block of 64 independent rows, each with its own point,
// direction and embedding, every product in f32.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _fwd_kernel (reached via
// _fused_fwd_call's pallas_call) under cfg.use_bf16 = False, and its
// has_time variant.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s: 531,968 MACs a row
// (the appearance projection is per row here), 2.08 ms at 131,072 rows,
// against 168 bytes a row of HBM traffic (~7 us).  The tile is
// field_f32.cuh's, one 64-row block a tile: the block loads its rows'
// points, directions and times, encodes them (y = 2^i x, the rays' form at
// z = 0), copies their embeddings into the A buffer of the appearance
// projection, runs the chain and writes the rows' rgb and sigma; a ragged
// last block is masked.
//
//   in : x, d (N,3), emb (N,E) f32 [, t (N) with use_time]; the weights
//        transposed, (K, N) f32 at their packed offsets
//   out: rgb (N,3), sigma (N) f32

#include "field_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

__global__ void __launch_bounds__(THREADS)
mlp_fwd_f32_kernel(const FieldArgs P, const float* __restrict__ wt, const Rays32 rows,
                   float* __restrict__ rgb, float* __restrict__ sigma) {
  Smem& sm = smem_f32();
  for (long long tile = blockIdx.x; tile < rows.n_tiles; tile += gridDim.x) {
    const long long row0 = tile * MB;
    const int n = (int)(rows.R - row0 < MB ? rows.R - row0 : MB);
    __syncthreads();  // every thread is done with the last block's rows
    load_rows(sm, rows, row0, n);
    field_block(P, wt, sm, RowEnc{P, rows.emb, row0, n}, sm.rgb, sm.sigma);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * n; i += THREADS) rgb[row0 * 3 + i] = sm.rgb[i];
    for (int i = threadIdx.x; i < n; i += THREADS) sigma[row0 + i] = sm.sigma[i];
  }
}

extern "C" int danerf_mlp_fwd_f32(const float* x, const float* d, const float* emb,
                                  const float* t, long long N, long long E, float* rgb,
                                  float* sigma, const float* wt, const float* vecs,
                                  const long long* meta, long long n_meta, void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, vecs, E, &P);
  if (err) return err;
  if (N < 0 || check_time(P, t)) return ERR_SHAPE;
  if (N == 0) return 0;
  const long long n_tiles = (N + MB - 1) / MB;
  unsigned grid = 0;
  const int e = launch_setup(mlp_fwd_f32_kernel, n_tiles, &grid);
  if (e) return e;
  const Rays32 rows{x, d, emb, t, nullptr, nullptr, nullptr, N, n_tiles, 1, MB, 0};
  mlp_fwd_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      P, wt, rows, rgb, sigma);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block takes.
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::f32::SMEM_BYTES; }
