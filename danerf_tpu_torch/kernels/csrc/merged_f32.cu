// K5 in f32 (use_bf16=False): hierarchical fine pass -- field at the
// importance depths only, rank merge with the coarse samples, composite
// over Sc + Sf, the field's products by 3xTF32 on the tensor cores.
//
// Replaces danerf_tpu/kernels/fused_render.py _merged_kernel (reached via
// _hier_pallas_fwd's pallas_call) under cfg.use_bf16 = False, and its
// has_time variant.
//
// Bound on an H100: operations: the field runs at Sf samples a ray
// (527,872 MACs each, three TF32 products each: 26.9 ms a 65,536-ray chunk
// at Sf = 64 at TF32's 494.7 TFLOP/s); the coarse samples' [r,g,b,sigma]
// come from K2's field output.  Per-ray HBM traffic is ~3.6 KB, ~0.24 GB a
// chunk, ~70 us.  The tile is field_f32_sm90.cuh's; the merge (field.cuh
// merge_ray: per-ray counting, a stable merge, coarse first on ties) runs
// in the activation buffer once the tile's field is done, then one warp a
// ray composites.  It takes the shapes the bf16 K5 takes (field.cuh
// merged_rpc).
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf) f32
//        [, t (R) with use_time]; the packed weights in f32 and split (hi,
//        lo: PackedParams.mats_tf32)
//   out: rgb (R,3), depth (R), acc (R), w (R,Sc+Sf), z_all (R,Sc+Sf)

#include "field_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

__global__ void __launch_bounds__(THREADS, 1)
merged_f32_kernel(const __grid_constant__ SplitMaps maps, const FieldArgs P,
                  const float* __restrict__ W, const Rays rays, float* __restrict__ rgb,
                  float* __restrict__ depth, float* __restrict__ acc, float* __restrict__ w,
                  float* __restrict__ zall) {
  Smem32& sm = smem32();
  init32(sm);
  if (threadIdx.x >= CONSUMERS) {
    produce(maps, P, W, rays);
    return;
  }
  consumer_regs();
  const int Sc = rays.pre_n, Sf = rays.s, Sa = Sc + Sf, rpc = rays.rpc;
  const int tiles = my_tiles(rays.n_tiles);
  const float* __restrict__ zc = rays.pre_z;
  const float* __restrict__ fc = rays.pre_f;
  float* zc_s = sm.act;            // rpc x Sc
  float* mz = zc_s + rpc * Sc;     // rpc x Sa
  float* msig = mz + rpc * Sa;     // rpc x Sa
  float* mrgb = msig + rpc * Sa;   // rpc x Sa x 3
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pipe pp;
  float fa[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long ray0 = (blockIdx.x + (long long)c * gridDim.x) * rpc;
    field_tile(P, W, sm, c, Sf, rpc, pp, fa);
    for (int idx = threadIdx.x; idx < rpc * Sc; idx += CONSUMERS) {
      const long long r = ray0 + idx / Sc;
      zc_s[idx] = r < rays.R ? zc[r * Sc + idx % Sc] : 0.f;
    }
    sm90::consumers_sync();
    const float* zs = sm.tr[c & 1].z;
    for (int j = warp; j < rpc; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      if (r >= rays.R) break;
      float* mzj = mz + j * Sa;
      float* msj = msig + j * Sa;
      float* mrj = mrgb + j * Sa * 3;
      merge_ray(sm.rgb, sm.sigma, zc_s + j * Sc, Sc, zs + j * Sf, Sf, fc + r * 4 * Sc, j * Sf,
                mzj, msj, mrj);
      composite_ray(mzj, msj, mrj, Sa, w + r * Sa, rgb + r * 3, depth + r, acc + r);
      for (int k = lane; k < Sa; k += 32) zall[r * Sa + k] = mzj[k];
    }
    end_tile(sm, c);
  }
}

extern "C" int danerf_merged_f32(const float* o, const float* d, const float* emb,
                                 const float* zc, const float* fc, const float* zf,
                                 const float* t, long long R, long long Sc, long long Sf,
                                 long long E, float* rgb, float* depth, float* acc, float* w,
                                 float* zall, const float* mats, const float* w_hi,
                                 const float* w_lo, const float* vecs, const long long* meta,
                                 long long n_meta, void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, vecs, E, &P);
  if (err) return err;
  if (check_time(P, t)) return ERR_SHAPE;
  const int rpc = merged_rpc(Sc, Sf);
  if (rpc == 0) return ERR_SHAPE;
  if (R == 0) return 0;
  const long long n_tiles = (R + rpc - 1) / rpc;
  SplitMaps maps;
  unsigned grid = 0;
  const int e = launch_setup(merged_f32_kernel, P, w_hi, w_lo, n_tiles, &maps, &grid);
  if (e) return e;
  const Rays rays{o, d, emb, t, zf, zc, fc, R, n_tiles, (int)Sf, rpc, (int)Sc};
  merged_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, P, mats, rays, rgb, depth, acc, w, zall);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a CTA takes (ptxas -v reports only static
// shared memory).
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::tf32::SMEM_BYTES; }
