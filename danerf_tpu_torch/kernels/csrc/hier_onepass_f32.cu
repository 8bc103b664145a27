// K9 in f32 (use_bf16=False): the whole hierarchical training step in one
// call -- the coarse march at z_c keeping its field and its residuals, the
// inverse CDF of the coarse weights at the given uniforms u, the
// rank-merged fine pass over the kept coarse field, both MSE terms, and
// the backward of both passes, every product and residual in f32; the
// coarse forward is never recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _hier_onepass_kernel (reached
// via _hier_onepass_pallas's pallas_call) under cfg.use_bf16 = False, with
// and without time.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s (FFMA, no tensor core).
// The field runs once at the Sc coarse and once at the Sf fine samples of a
// ray (527,872 MACs a sample) and its transposed chain once at each
// (1,024,128 MACs a sample): (Sc + Sf) x 1,552,000 MACs a ray, 6.07 ms for
// a 1024-ray batch of 64 + 64.  Per-ray HBM traffic is ~0.7 KB in and 0.13
// KB out; the f32 stash holds the rows of both passes (~18 KB a sample row,
// ~2.4 GB at that batch, written and read back once: ~1.4 ms).
//
// Design (csrc/field_bwd_f32.cuh: field_f32.cuh's FFMA tile with its
// stash, the merged composite merged_ray32, the chain and the FFMA dW
// pass), in the phases of hier_onepass.cu.  A tile is rpc rays, rpc =
// rays_per_tile(max(Sc, Sf)), and two virtual tiles of the stash: 2b for
// its coarse rows (rpc x Sc) and 2b + 1 for its fine rows (rpc x Sf), each
// with its stash rows and row-sum slots.  One dW pass sums both row sets;
// hier_losses sums the fine and the coarse loss slots apart, in tile
// order.  Per tile:
//   1. Coarse forward (stash at 2b).  Each ray's coarse depths, its field
//      [r, g, b, sigma] and sigma_pre are kept in HierSmem32: the fine
//      forward overwrites the tile's arrays and streams its weights through
//      the stages that hold the composites' arrays.
//   2. One warp per ray: the coarse composite, then the inverse CDF of its
//      f32 weights (bwd_tiles.cuh inverse_cdf), the fine depths into sm.z
//      (zeros past the valid rays); its arrays in the weight stages.
//   3. Fine forward at the new depths (stash at 2b + 1).
//   4. The merged composite in the weight stages (merged_ray32: merge with
//      the kept coarse field, composite, fine MSE, transpose, un-permute:
//      coarse ranks to the coarse field's cotangent, kept in HierSmem32;
//      fine ranks to the fine rows); the fine chain, each ray's d_happ
//      summed into bs.dsum.
//   5. Coarse backward on the stashed coarse residuals, no MLP recompute:
//      the kept field restored, the coarse composite recomputed and
//      transposed under cw x the coarse MSE's cotangent, plus step 4's
//      coarse-field cotangent; the coarse chain (the chain's head reads the
//      last trunk layer from the stash), its d_happ added to the same sums;
//      then each ray's demb = those sums @ Wapp.
// Every sum runs in a fixed order and nothing is added atomically, so two
// calls give bit-identical results.  A pass holds at most
// MAX_TILES_PASS32 / 2 tiles (131,072 stash rows of both sets).
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), u (R,Sf), target (R,3) f32
//        [, t (R) with use_time]; cw = coarse_loss_weight; mats, mats_t,
//        meta_t as K3's f32 entry
//   out: gmats, gvecs (packed-layout f32 gradients of mse_f + cw mse_c,
//        added to), demb (R,E), loss[0] = mse_f, loss[1] = mse_c (added to)

#include "field_bwd_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

// The tile kernel: for each tile of this block, steps 1-5.
__global__ void __launch_bounds__(THREADS)
hier32_tile(const FieldArgs P, const float* __restrict__ wt, const float* __restrict__ w,
            const Scratch32 sc, const Rays32 rays, long long ray_base, const HierArgs ha,
            float* __restrict__ demb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemH32& sh = *reinterpret_cast<SmemH32*>(smem_raw);
  SmemB32& sb = sh.b;
  Smem& sm = sb.f;
  BwdSmem& bs = sb.bs;
  HierSmem32& hs = sh.h;
  const int Sc = ha.Sc, Sf = ha.Sf, Sa = Sc + Sf, rpc = rays.rpc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const RayCot cot{ha.target, ha.inv_denom, nullptr, nullptr, nullptr, nullptr};
  Scratch sums{};  // store_tile_loss reads part and nv only
  sums.part = sc.part;
  sums.nv = sc.nv;
  for (long long tile = blockIdx.x; tile < rays.n_tiles; tile += gridDim.x) {
    const long long ray0 = ray_base + tile * rpc;
    const long long vc = 2 * tile, vf = vc + 1;  // the virtual tiles of the stash
    const int n_rays = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    __syncthreads();  // every thread is done with the last tile
    load_rays(sm, rays, ray0, n_rays);
    for (int i = threadIdx.x; i < rpc * Sc; i += THREADS)
      hs.zc[i] = i < n_rays * Sc ? ha.zc[ray0 * Sc + i] : 0.f;
    for (int i = threadIdx.x; i < rpc * HALF; i += THREADS) bs.dsum[i] = 0.f;
    zero_cotangents32(bs);

    // 1. the coarse forward; keep its field
    forward_set<false>(P, wt, sb, sc, rays, ray0, n_rays, Sc, vc * TILE_M);
    for (int idx = threadIdx.x; idx < rpc * Sc; idx += THREADS) {
      const int j = idx / Sc, i = idx - j * Sc;
      float* f = hs.kf + j * 4 * Sc;
      f[i] = sm.rgb[idx * 3 + 0];
      f[Sc + i] = sm.rgb[idx * 3 + 1];
      f[2 * Sc + i] = sm.rgb[idx * 3 + 2];
      f[3 * Sc + i] = sm.sigma[idx];
      hs.ksp[idx] = sb.sigma_pre[idx];
    }

    // 2. the coarse composite and the inverse CDF of its weights into sm.z
    //    (the coarse forward is done with it), zeros past the valid rays
    for (int j = warp; j < rpc; j += THREADS / 32) {
      float* zf = sm.z + j * Sf;
      if (j < n_rays) {
        float* al = sm.w[0] + warp * 3 * Sc;
        float out[5];
        composite_keep(hs.zc + j * Sc, sm.sigma + j * Sc, sm.rgb + j * Sc * 3, Sc, al, al + Sc,
                       al + 2 * Sc, out);
        __syncwarp();
        inverse_cdf(hs.zc + j * Sc, al + 2 * Sc, Sc, ha.u + (ray0 + j) * Sf, Sf, al, zf);
      } else {
        for (int i = lane; i < Sf; i += 32) zf[i] = 0.f;
      }
    }
    __syncthreads();

    // 3. the fine forward at the new depths
    forward_set<false>(P, wt, sb, sc, rays, ray0, n_rays, Sf, vf * TILE_M);

    // 4. the merged composite, the fine MSE and its transpose (each ray's
    //    alpha / T / w, then its merge arrays, in the weight stages); the
    //    fine chain
    {
      float* merge = sm.w[0] + (THREADS / 32) * 3 * Sa;  // rpc x 6 Sa
      for (int j = warp; j < n_rays; j += THREADS / 32)
        merged_ray32<true>(sm.rgb, sm.sigma, bs, cot, ray0 + j, j, hs.zc + j * Sc, Sc,
                           sm.z + j * Sf, Sf, hs.kf + j * 4 * Sc, hs.gfc + j * 4 * Sc,
                           sm.w[0] + warp * 3 * Sa, merge + j * 6 * Sa);
    }
    __syncthreads();
    store_tile_loss<true>(bs, sums, (int)(2 * vf), n_rays);
    chain_blocks(P, w, sb, sc, vf * TILE_M, (n_rays * Sf + MB - 1) / MB, Sf, n_rays,
                 sc.part + 2 * vf * sc.nv, nullptr);
    __syncthreads();

    // 5. the coarse backward: the kept field restored, the coarse composite
    //    recomputed and transposed under cw x the coarse MSE's cotangent,
    //    plus step 4's coarse-field cotangent; then the coarse chain
    zero_cotangents32(bs);
    for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
      const int j = row / Sc, i = row - j * Sc;
      const bool ok = j < rpc;
      const float* f = hs.kf + (ok ? j : 0) * 4 * Sc;
      sm.rgb[row * 3 + 0] = ok ? f[i] : 0.f;
      sm.rgb[row * 3 + 1] = ok ? f[Sc + i] : 0.f;
      sm.rgb[row * 3 + 2] = ok ? f[2 * Sc + i] : 0.f;
      sm.sigma[row] = ok ? f[3 * Sc + i] : 0.f;
      sb.sigma_pre[row] = ok ? hs.ksp[row] : 0.f;
    }
    __syncthreads();
    for (int j = warp; j < n_rays; j += THREADS / 32) {
      const long long r = ray0 + j;
      const float* zc = hs.zc + j * Sc;
      float* al = sm.w[0] + warp * 3 * Sc;
      float out[5];
      composite_keep(zc, sm.sigma + j * Sc, sm.rgb + j * Sc * 3, Sc, al, al + Sc, al + 2 * Sc,
                     out);
      const float d0 = out[0] - ha.target[r * 3 + 0];
      const float d1 = out[1] - ha.target[r * 3 + 1];
      const float d2 = out[2] - ha.target[r * 3 + 2];
      if (lane == 0) bs.loss[j] = (d0 * d0 + d1 * d1 + d2 * d2) * ha.inv_denom;
      composite_bwd(zc, sm.rgb + j * Sc * 3, Sc, al, al + Sc, al + 2 * Sc, out[3], out[4],
                    ha.kc * d0, ha.kc * d1, ha.kc * d2, 0.f, 0.f, nullptr, bs.g_rgb + j * Sc * 3,
                    bs.g_sig + j * Sc);
      __syncwarp();
      const float* gf = hs.gfc + j * 4 * Sc;
      for (int i = lane; i < Sc; i += 32) {
        const int row = j * Sc + i;
        bs.g_rgb[row * 3 + 0] += gf[i];
        bs.g_rgb[row * 3 + 1] += gf[Sc + i];
        bs.g_rgb[row * 3 + 2] += gf[2 * Sc + i];
        bs.g_sig[row] += gf[3 * Sc + i];
      }
    }
    __syncthreads();
    store_tile_loss<true>(bs, sums, (int)(2 * vc), n_rays);
    chain_blocks(P, w, sb, sc, vc * TILE_M, (n_rays * Sc + MB - 1) / MB, Sc, n_rays,
                 sc.part + 2 * vc * sc.nv, nullptr);
    __syncthreads();
    ray_demb(P, w, bs, ray0, n_rays, demb);
  }
}

// Bytes of stash K9 in f32 needs for R rays of s = max(Sc, Sf) samples a
// tile row group: the residuals of both row sets of every tile of one pass;
// negative on a malformed layout or a shape it does not take.
extern "C" long long danerf_hier_onepass_f32_scratch_bytes(const long long* meta,
                                                           long long n_meta, long long R,
                                                           long long s, long long n_vecs) {
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  const int units = tile_units32(s, false);
  if (units == 0 || R < 0) return ERR_SHAPE;
  return scratch32_bytes(P, R, units, 2, n_vecs);
}

// The dynamic shared memory of a block of K9's f32 tile kernel.
extern "C" long long danerf_hier_tile_smem_bytes() { return (long long)HIER32_SMEM_BYTES; }

extern "C" int danerf_hier_onepass_f32(const float* o, const float* d, const float* emb,
                                       const float* zc, const float* u, const float* target,
                                       const float* t, long long R, long long Sc, long long Sf,
                                       long long E, double cw, float* gmats, float* gvecs,
                                       float* demb, float* loss, const void* mats,
                                       const float* vecs, const long long* meta,
                                       long long n_meta, const void* mats_t,
                                       const long long* meta_t, long long n_meta_t,
                                       void* scratch, long long scratch_bytes, long long n_vecs,
                                       void* stream) {
  if (Sc < 1 || Sf < 1 || Sc > TILE_M || Sf > TILE_M) return ERR_SHAPE;
  Bwd32Call c;
  const int err = bwd32_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R,
                              Sc > Sf ? Sc : Sf, scratch, scratch_bytes, n_vecs, &c, false, 2);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  if (hier_smem_bytes((int)Sc, (int)Sf, c.rpc, c.P.emb_dim) > 232448) return ERR_SHAPE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HierArgs ha{zc, u, target, 1.f / (float)(R * 3.0), (float)(2.0 * cw / (R * 3.0)),
                    (int)Sc, (int)Sf};
  Rays32 rays{o, d, emb, t, zc, nullptr, nullptr, R, 0, (int)Sc, c.rpc, 0};
  const Scratch32& sc = c.sc;
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    cudaError_t e = cudaMemsetAsync(sc.part, 0, sizeof(float) * 4 * nt * sc.nv, st);
    if (e != cudaSuccess) return (int)e;
    unsigned grid = 0;
    const int lerr = launch_setup(hier32_tile, nt, &grid, HIER32_SMEM_BYTES);
    if (lerr) return lerr;
    rays.n_tiles = nt;
    hier32_tile<<<grid, THREADS, HIER32_SMEM_BYTES, st>>>(c.P, c.wt, c.w, sc, rays, t0 * c.rpc,
                                                          ha, demb);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int ferr = finish32(c, 2 * nt, gmats, gvecs, nullptr, (int)n_vecs, st);
    if (ferr) return ferr;
    hier_losses<<<1, 64, 0, st>>>(sc.part, 2 * nt, sc.nv, loss);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
