// K1: the NeRF-W field on flat points -- encode + trunk + heads per tile of
// 128 independent rows, each with its own point, direction and embedding.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _fwd_kernel (reached via
// _fused_fwd_call's pallas_call), the forward of fused_nerf_apply.
//
// Bound on an H100: operations.  531,968 MACs a row (the appearance
// projection, 4,096 MACs, is per row here), so 131,072 rows (the fine pass
// of a 1024-ray batch at 128 samples) are ~0.14 TFLOP, 0.141 ms at 989
// TFLOP/s bf16 dense, against 168 bytes a row of HBM traffic (~7 us).  So
// the design is field.cuh's: the MLP on the tensor cores (bf16 mma.sync,
// f32 accumulation) with the activations in shared memory, and only the
// per-row inputs and outputs in HBM.  The per-row embedding is staged in
// bf16 and emb @ Wapp^T is one more tensor-core product, kept in registers
// beside the dir layer's accumulator and added after its relu (the JAX
// order).  A ragged last tile is masked, not padded by the caller.
//
//   in : x, d (N,3), emb (N,E) f32 [, t (N) with use_time]
//   out: rgb (N,3), sigma (N) f32

#include "field.cuh"

using namespace danerf;

__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const FieldArgs P, const float* __restrict__ x, const float* __restrict__ d,
               const float* __restrict__ emb, const float* __restrict__ t, long long N,
               float* __restrict__ rgb,
               float* __restrict__ sigma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  RowSmem& rs = *reinterpret_cast<RowSmem*>(smem_raw + sizeof(Smem));
  const long long row0 = (long long)blockIdx.x * TILE_M;
  const int nvalid = (int)(N - row0 < TILE_M ? N - row0 : TILE_M);

  load_rows(rs, x, d, emb, t, P.emb_dim, row0, nvalid);
  __syncthreads();
  encode_rows(P, sm, rs, nvalid);
  __syncthreads();
  field_tile(P, sm, rs.emb);

  for (int r = threadIdx.x; r < nvalid; r += THREADS) {
    rgb[(row0 + r) * 3 + 0] = sm.rgb[r * 3 + 0];
    rgb[(row0 + r) * 3 + 1] = sm.rgb[r * 3 + 1];
    rgb[(row0 + r) * 3 + 2] = sm.rgb[r * 3 + 2];
    sigma[row0 + r] = sm.sigma[r];
  }
}

extern "C" int danerf_mlp_fwd(const float* x, const float* d, const float* emb, const float* t,
                              long long N,
                              long long E, float* rgb, float* sigma, const void* mats,
                              const float* vecs, const long long* meta, long long n_meta,
                              void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, mats, vecs, E, &P);
  if (err) return err;
  if (P.emb_dim % 16 || N < 0 || check_time(P, t)) return ERR_SHAPE;   // emb @ Wapp^T steps K by 16
  if (N == 0) return 0;
  const size_t smem = sizeof(Smem) + sizeof(RowSmem);
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (N + TILE_M - 1) / TILE_M;
  mlp_fwd_kernel<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      P, x, d, emb, t, N, rgb, sigma);
  return (int)cudaGetLastError();
}
