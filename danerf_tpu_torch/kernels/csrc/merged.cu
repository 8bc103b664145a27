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
// is field_sm90.cuh's Hopper tile (persistent CTAs, a TMA weight ring,
// wgmma); the merge replaces the TPU kernel's one-hot permutation matmuls
// with per-ray counting (a stable merge, coarse first on ties; both inputs
// arrive sorted) in the activation buffer, free once both warpgroups have
// run the heads; then one warp per ray composites the merged samples with
// a product scan.
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf) f32
//        [, t (R) with use_time]
//   out: rgb (R,3), depth (R), acc (R), w (R,Sc+Sf), z_all (R,Sc+Sf)

#include "field_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

// The merge arrays of a tile: zc (rpc x Sc), then merged z, sigma (rpc x Sa)
// and rgb (rpc x Sa x 3).  The shapes K5 takes are those whose arrays fit
// beside its first design's tile in 232,448 bytes (field.cuh
// SHAPE_TILE_BYTES); all of them fit in the activation buffer.
constexpr size_t MERGE_MAX = 232448 - SHAPE_TILE_BYTES;
static_assert(MERGE_MAX <= sizeof(Smem90::act), "the merge arrays must fit in sm.act");

// Stable rank merge of one ray's samples by one warp: the sorted coarse
// depths zc (Sc) with their field fc (the ray's (4, Sc) slice of K2's
// output) and the sorted fine depths zf (Sf) whose field is the tile's rows
// row0.. of rgb_s / sig_s.  rank_c = i + #{z_f < z_c[i]}, rank_f = j +
// #{z_c <= z_f[j]} (field_bwd_sm90.cuh merge_ray_ranks's ranks).
__device__ void merge_ray90(const float* rgb_s, const float* sig_s, const float* zc, int Sc,
                            const float* zf, int Sf, const float* __restrict__ fc, int row0,
                            float* mz, float* msig, float* mrgb) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < Sc; i += 32) {
    const float zv = zc[i];
    int cnt = 0;
    for (int k = 0; k < Sf; ++k) cnt += zf[k] < zv;
    const int k = i + cnt;
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
    mz[k] = zv;
    mrgb[k * 3 + 0] = rgb_s[row * 3 + 0];
    mrgb[k * 3 + 1] = rgb_s[row * 3 + 1];
    mrgb[k * 3 + 2] = rgb_s[row * 3 + 2];
    msig[k] = sig_s[row];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS90, 1)
merged_kernel(const __grid_constant__ WeightMaps maps, const FieldArgs P, const Rays rays,
              float* __restrict__ rgb, float* __restrict__ depth, float* __restrict__ acc,
              float* __restrict__ w, float* __restrict__ zall) {
  Smem90& sm = smem90();
  init_ring(sm);
  if (is_producer()) {
    produce(maps, P, rays);
    return;
  }
  consumer_regs();
  const int Sc = rays.pre_n, Sf = rays.s, Sa = Sc + Sf;
  const int rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const float* __restrict__ zc = rays.pre_z;
  const float* __restrict__ fc = rays.pre_f;
  float* zc_s = reinterpret_cast<float*>(sm.act);  // rpc x Sc
  float* mz = zc_s + rpc * Sc;                     // rpc x Sa
  float* msig = mz + rpc * Sa;                     // rpc x Sa
  float* mrgb = msig + rpc * Sa;                   // rpc x Sa x 3
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pipe pp;
  float fa[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long ray0 = (blockIdx.x + (long long)c * gridDim.x) * rpc;
    field_tile90(P, sm, c, Sf, rpc, pp, fa);
    for (int idx = threadIdx.x; idx < rpc * Sc; idx += CONSUMERS) {
      const long long r = ray0 + idx / Sc;
      zc_s[idx] = r < rays.R ? zc[r * Sc + idx % Sc] : 0.f;
    }
    consumers_sync();
    const float* zs = sm.enc[c & 1].z;
    for (int j = warp; j < rpc; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      if (r >= rays.R) break;
      float* mzj = mz + j * Sa;
      float* msj = msig + j * Sa;
      float* mrj = mrgb + j * Sa * 3;
      merge_ray90(sm.rgb, sm.sigma, zc_s + j * Sc, Sc, zs + j * Sf, Sf, fc + r * 4 * Sc, j * Sf,
                  mzj, msj, mrj);
      composite_ray(mzj, msj, mrj, Sa, w + r * Sa, rgb + r * 3, depth + r, acc + r);
      for (int k = lane; k < Sa; k += 32) zall[r * Sa + k] = mzj[k];
    }
    end_tile(sm, c);
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
  if (sizeof(float) * rpc * (Sc + 5 * (Sc + Sf)) > MERGE_MAX) return ERR_SHAPE;
  const long long n_tiles = (R + rpc - 1) / rpc;
  WeightMaps maps;
  unsigned grid = 0;
  const int e = launch_setup(merged_kernel, P, n_tiles, &maps, &grid);
  if (e) return e;
  const Rays rays{o, d, emb, t, zf, zc, fc, R, n_tiles, (int)Sf, rpc, (int)Sc};
  merged_kernel<<<grid, THREADS90, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, P, rays, rgb, depth, acc, w, zall);
  return (int)cudaGetLastError();
}
