// K5: hierarchical fine pass -- field at the importance depths only, rank
// merge with the coarse samples, composite over Sc + Sf.
//
// Replaces danerf_tpu/kernels/fused_render.py _merged_kernel (reached via
// _hier_pallas_fwd's pallas_call).
//
// Bound on an H100: operations.  The field runs at Sf samples per ray
// (531,968 MACs each: ~4.5 TFLOP per 65,536-ray chunk at Sf = 64, ~4.5 ms at
// 989 TFLOP/s bf16); the coarse samples' [r,g,b,sigma] come from K2's field
// output instead of a second MLP evaluation.  Per-ray HBM traffic is ~3.6 KB
// (field_c in, weights and z_all out), ~0.24 GB per chunk, ~70 us.  The MLP
// is field.cuh's tensor-core tile; the merge replaces the TPU kernel's
// one-hot permutation matmuls with per-ray counting in shared memory
// (field.cuh merge_ray: a stable merge, coarse first on ties; both inputs
// arrive sorted), then one warp per ray composites the merged samples with
// a product scan.
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf) f32
//        [, t (R) with use_time]
//   out: rgb (R,3), depth (R), acc (R), w (R,Sc+Sf), z_all (R,Sc+Sf)

#include "field.cuh"

using namespace danerf;

__global__ void __launch_bounds__(THREADS, 1)
merged_kernel(const FieldArgs P, const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ emb, const float* __restrict__ zc,
              const float* __restrict__ fc, const float* __restrict__ zf,
              const float* __restrict__ t, long long R, int Sc,
              int Sf, int rpc, float* __restrict__ rgb, float* __restrict__ depth,
              float* __restrict__ acc, float* __restrict__ w, float* __restrict__ zall) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int Sa = Sc + Sf;
  float* zc_s = reinterpret_cast<float*>(smem_raw + sizeof(Smem));  // rpc x Sc
  float* mz = zc_s + rpc * Sc;                                        // rpc x Sa
  float* msig = mz + rpc * Sa;                                        // rpc x Sa
  float* mrgb = msig + rpc * Sa;                                      // rpc x Sa x 3
  const long long ray0 = (long long)blockIdx.x * rpc;

  load_rays(sm, o, d, emb, t, P.emb_dim, ray0, rpc, R);
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / Sf;
    const long long r = ray0 + j;
    sm.z[row] = (j < rpc && r < R) ? zf[r * Sf + (row - j * Sf)] : 0.f;
  }
  for (int idx = threadIdx.x; idx < rpc * Sc; idx += THREADS) {
    const long long r = ray0 + idx / Sc;
    zc_s[idx] = r < R ? zc[r * Sc + idx % Sc] : 0.f;
  }
  __syncthreads();
  encode_tile(P, sm, Sf, rpc);
  __syncthreads();
  field_tile(P, sm, Sf, rpc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < rpc; j += WARPS) {
    const long long r = ray0 + j;
    if (r >= R) break;
    float* mzj = mz + j * Sa;
    float* msj = msig + j * Sa;
    float* mrj = mrgb + j * Sa * 3;
    merge_ray(sm, zc_s + j * Sc, Sc, sm.z + j * Sf, Sf, fc + r * 4 * Sc, j * Sf, mzj, msj, mrj,
              nullptr, nullptr);
    composite_ray(mzj, msj, mrj, Sa, w + r * Sa, rgb + r * 3, depth + r, acc + r);
    for (int k = lane; k < Sa; k += 32) zall[r * Sa + k] = mzj[k];
  }
}

extern "C" int danerf_merged(const float* o, const float* d, const float* emb, const float* zc,
                             const float* fc, const float* zf, const float* t, long long R,
                             long long Sc,
                             long long Sf, long long E, float* rgb, float* depth, float* acc,
                             float* w, float* zall, const void* mats, const float* vecs,
                             const long long* meta, long long n_meta, void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, mats, vecs, E, &P);
  if (err) return err;
  if (check_time(P, t)) return ERR_SHAPE;
  if (Sf < 1 || Sf > TILE_M || Sc < 1 || Sc + Sf > 1024) return ERR_SHAPE;
  if (R == 0) return 0;
  const int rpc = (int)(TILE_M / Sf < MAX_RPC ? TILE_M / Sf : MAX_RPC);
  const size_t smem = sizeof(Smem) + sizeof(float) * rpc * (Sc + 5 * (Sc + Sf));
  if (smem > 232448) return ERR_SHAPE;
  cudaError_t e = cudaFuncSetAttribute(merged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (R + rpc - 1) / rpc;
  merged_kernel<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      P, o, d, emb, zc, fc, zf, t, R, (int)Sc, (int)Sf, rpc, rgb, depth, acc, w, zall);
  return (int)cudaGetLastError();
}
