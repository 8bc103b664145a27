// K9: the whole hierarchical training step in one call -- the coarse march
// at z_c keeping its field and its residuals, the inverse CDF of the coarse
// weights at the given uniforms u, the rank-merged fine pass over the kept
// coarse field, both MSE terms, and the backward of both passes; the coarse
// forward is never recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _hier_onepass_kernel (reached
// via _hier_onepass_pallas's pallas_call), with and without time.
//
// Bound on an H100: operations.  The field runs once at the Sc coarse and
// once at the Sf fine samples of a ray (527,872 MACs a sample) and its
// transposed chain once at each (1,024,128 MACs a sample): (Sc + Sf) x
// 1,552,000 MACs a ray, 0.41 ms for a 1024-ray batch of 64 + 64 at 989
// TFLOP/s bf16 dense, where the two-kernel step (K2 + K4 + K3, whose K3
// recomputes the coarse forward) is bound at 0.48 ms.  Per-ray HBM traffic
// is ~0.7 KB in and 0.13 KB out; the residual scratch holds the rows of both
// passes (~9.5 KB a sample row, field_bwd.cuh Scratch).
//
// Design: field_bwd_sm90.cuh's persistent tile (a TMA weight ring, wgmma
// for the forward and the transposed chain, the wgmma dW pass), its phases
// in K9's order.  A tile is rpc rays, rpc = rays_per_tile(max(Sc, Sf)), and
// two virtual tiles of the scratch: 2b for its coarse rows (rpc x Sc) and
// 2b + 1 for its fine rows (rpc x Sf), each with its stash rows, row-sum
// slots and set of relu gate masks (the CTA's gate area holds both sets).
// One dW pass sums both row sets; hier_losses sums the fine and the coarse
// loss slots apart, in tile order.  Per tile:
//   1. Coarse forward (stash at 2b).  The coarse field [r, g, b, sigma] and
//      sigma_pre are kept in shared memory (HierSmem): the fine forward
//      overwrites the tile's arrays.
//   2. One warp per ray: the coarse composite, then the inverse CDF of its
//      weights (inverse_cdf): a warp prefix sum over Sc instead of the TPU's
//      triangular matmul, and a count #{cdf < u} per uniform for its
//      bracket, as merge_ray_ranks counts ranks instead of the one-hot
//      matmuls.  The fine depths go into the encoding buffer, which the
//      coarse forward is done with, and the consumers signal zf_ready: the
//      encoders encode the fine rows then, not ahead (they prefetch only the
//      next tile's coarse rows, during this tile's chains), so the fine
//      forward waits for one encode (~1/20 of a tile's time).
//   3. Fine forward at the new depths (stash at 2b + 1).
//   4. The merged composite in the weight ring (which the producer leaves
//      empty until comp_done): merge with the kept coarse field, composite,
//      fine MSE, transpose, un-permute (coarse ranks to the coarse field's
//      cotangent, kept; fine ranks to the fine rows); the fine chain.
//   5. Coarse backward on the stashed coarse residuals, no MLP recompute:
//      the kept field restored, the cheap coarse composite recomputed and
//      transposed under cw x the coarse MSE's cotangent, plus step 4's
//      coarse-field cotangent; the chain's head reads the last coarse trunk
//      layer from the stash; the transposed chain, its demb added to the
//      fine one.
// The producer streams the forward's weights twice (coarse, fine), then,
// after comp_done, the transposed blocks twice (fine chain, coarse chain).
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), u (R,Sf), target (R,3) f32
//        [, t (R) with use_time]; cw = coarse_loss_weight
//   out: gmats, gvecs (packed-layout f32 gradients of mse_f + cw mse_c,
//        added to), demb (R,E), loss[0] = mse_f, loss[1] = mse_c (added to)

#include "field_bwd_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

__device__ __forceinline__ void zero_cotangents(SmemBwd& sm) {
  for (int r = threadIdx.x; r < ROWS; r += CONSUMERS) {
    sm.bs.g_sig[r] = 0.f;
    sm.bs.g_rgb[r * 3 + 0] = 0.f; sm.bs.g_rgb[r * 3 + 1] = 0.f; sm.bs.g_rgb[r * 3 + 2] = 0.f;
  }
}

// The tile kernel: for each tile of this CTA, steps 1-5.
__global__ void __launch_bounds__(THREADS90, 1)
hier_tile90(const __grid_constant__ BwdMaps maps, const FieldArgs P, const Scratch sc,
            uint4* __restrict__ gates_all, const BwdRays rays, const HierArgs ha,
            float* __restrict__ demb) {
  SmemBwd& sm = smem_bwd();
  init_bwd(sm);
  if (is_producer()) {
    produce_bwd<HIER>(maps, P, rays, sc);
    return;
  }
  consumer_regs();
  const int L = P.num_layers, Sc = ha.Sc, Sf = ha.Sf;
  uint4* gates_c = gates_all + (long long)blockIdx.x * 2 * (L + 1) * CONSUMERS;
  uint4* gates_f = gates_c + (L + 1) * CONSUMERS;
  const int rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sa = Sc + Sf;
  const RayCot cot{ha.target, ha.inv_denom, nullptr, nullptr, nullptr, nullptr};
  float* ring = reinterpret_cast<float*>(sm.ring);
  BwdSmem& bs = sm.bs;
  HierSmem& hs = sm.hier;
  Pipe pp;
  float acc[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long tile = blockIdx.x + (long long)c * gridDim.x;
    const long long vc = 2 * tile, vf = vc + 1;  // the virtual tiles of the scratch
    const long long ray0 = rays.ray_base + tile * rpc;
    const int nvalid = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);

    // 1. the coarse forward; keep its field
    forward_tile<HIER>(P, maps, sm, sc, gates_c, c, 0, false, vc * ROWS, Sc, rpc, pp, acc);
    for (int idx = threadIdx.x; idx < rpc * Sc; idx += CONSUMERS) {
      const int j = idx / Sc, i = idx - j * Sc;
      float* f = hs.kf + j * 4 * Sc;
      f[i] = sm.rgb[idx * 3 + 0];
      f[Sc + i] = sm.rgb[idx * 3 + 1];
      f[2 * Sc + i] = sm.rgb[idx * 3 + 2];
      f[3 * Sc + i] = sm.sigma[idx];
      hs.ksp[idx] = sm.sigma_pre[idx];
    }

    // 2. the coarse composite and the inverse CDF of its weights, into the
    //    encoding buffer's depths (zeros past the valid rays)
    for (int j = warp; j < rpc; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      float* zf = sm.enc.z + j * Sf;
      if (j < nvalid) {
        float* al = hs.scr + j * 3 * Sc;
        float out[5];
        composite_keep(ha.zc + r * Sc, sm.sigma + j * Sc, sm.rgb + j * Sc * 3, Sc, al, al + Sc,
                       al + 2 * Sc, out);
        __syncwarp();
        inverse_cdf(ha.zc + r * Sc, al + 2 * Sc, Sc, ha.u + r * Sf, Sf, al, zf);
      } else {
        for (int i = lane; i < Sf; i += 32) zf[i] = 0.f;
      }
    }
    consumers_sync();
    if (threadIdx.x == 0) mbar_arrive(&sm.zf_ready);

    // 3. the fine forward at the new depths
    zero_cotangents(sm);
    forward_tile<HIER>(P, maps, sm, sc, gates_f, c, 1, true, vf * ROWS, Sf, rpc, pp, acc);

    // 4. the merged composite, the fine MSE and its transpose (merged_ray's
    //    arrays in the ring: each ray's alpha / T / w, then its merge
    //    arrays); the fine chain
    for (int j = warp; j < nvalid; j += CONSUMERS / 32)
      merged_ray<true>(sm, cot, ray0 + j, j, ha.zc + (ray0 + j) * Sc, Sc, sm.enc.z + j * Sf, Sf,
                       hs.kf + j * 4 * Sc, hs.gfc + j * 4 * Sc, ring + j * 3 * Sa,
                       ring + rpc * 3 * Sa + j * 6 * Sa);
    fence_proxy_async();  // the ring's generic writes before the producer's next loads
    consumers_sync();
    if (threadIdx.x == 0) {
      mbar_arrive(&sm.comp_done);
      mbar_arrive(&sm.enc_empty);
    }
    store_tile_loss<true>(bs, sc, (int)(2 * vf), nvalid);
    chain_head<HIER>(P, sm, sc, gates_f, vf, vf * ROWS, Sf, nvalid, ray0, demb, false, nullptr,
                     pp, acc);
    chain(P, maps, sm, sc, gates_f, vf, vf * ROWS, pp, acc);

    // 5. the coarse backward: the kept field restored, the coarse composite
    //    recomputed and transposed under cw x the coarse MSE's cotangent,
    //    plus step 4's coarse-field cotangent; the chain's head reads the
    //    last coarse trunk layer from the stash, whose stores are complete
    zero_cotangents(sm);
    for (int row = threadIdx.x; row < ROWS; row += CONSUMERS) {
      const int j = row / Sc, i = row - j * Sc;
      const bool ok = j < rpc;
      const float* f = hs.kf + (ok ? j : 0) * 4 * Sc;
      sm.rgb[row * 3 + 0] = ok ? f[i] : 0.f;
      sm.rgb[row * 3 + 1] = ok ? f[Sc + i] : 0.f;
      sm.rgb[row * 3 + 2] = ok ? f[2 * Sc + i] : 0.f;
      sm.sigma[row] = ok ? f[3 * Sc + i] : 0.f;
      sm.sigma_pre[row] = ok ? hs.ksp[row] : 0.f;
    }
    if ((threadIdx.x & 127) == 0) {
      bulk_wait();
      fence_proxy_async_global();
    }
    consumers_sync();
    for (int j = warp; j < nvalid; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      const float* zc = ha.zc + r * Sc;
      float* al = hs.scr + j * 3 * Sc;
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
    consumers_sync();
    store_tile_loss<true>(bs, sc, (int)(2 * vc), nvalid);
    chain_head<HIER>(P, sm, sc, gates_c, vc, vc * ROWS, Sc, nvalid, ray0, demb, true,
                     sc.h + ((L - 1) * sc.rows + vc * ROWS) * HID, pp, acc);
    chain(P, maps, sm, sc, gates_c, vc, vc * ROWS, pp, acc);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
}

// Bytes of scratch K9 needs for R rays of s = max(Sc, Sf) samples a tile
// row group: the residuals of both row sets of every tile of one pass and
// two gate-mask sets a CTA; negative on a malformed layout.
extern "C" long long danerf_hier_onepass_scratch_bytes(const long long* meta, long long n_meta,
                                                       long long R, long long s, long long n_vecs) {
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  if (s < 1 || s > TILE_M || R < 0) return ERR_SHAPE;
  const int rpc = rays_per_tile(s);
  long long tiles = (R + rpc - 1) / rpc;
  if (tiles > MAX_TILES_PER_PASS / 2) tiles = MAX_TILES_PER_PASS / 2;
  Scratch90 sc;
  return carve90(nullptr, P, 2 * tiles, (int)n_vecs, &sc, 2);
}

extern "C" int danerf_hier_onepass(const float* o, const float* d, const float* emb,
                                   const float* zc, const float* u, const float* target,
                                   const float* t, long long R, long long Sc, long long Sf,
                                   long long E, double cw, float* gmats, float* gvecs,
                                   float* demb, float* loss, const void* mats, const float* vecs,
                                   const long long* meta, long long n_meta, const void* mats_t,
                                   const long long* meta_t, long long n_meta_t, void* scratch,
                                   long long scratch_bytes, long long n_vecs, void* stream) {
  if (Sc < 1 || Sf < 1 || Sc > TILE_M || Sf > TILE_M) return ERR_SHAPE;
  Bwd90Call c;
  const int err = bwd90_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R,
                              Sc > Sf ? Sc : Sf, scratch, scratch_bytes, n_vecs, &c, false, 2);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  if (hier_smem_bytes((int)Sc, (int)Sf, c.rpc, c.P.emb_dim) > 232448) return ERR_SHAPE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HierArgs ha{zc, u, target, 1.f / (float)(R * 3.0), (float)(2.0 * cw / (R * 3.0)),
                    (int)Sc, (int)Sf};
  const BwdRays rays{o, d, emb, t, zc, R, 0, 0, (int)Sc, c.rpc, (int)Sf};
  return run_passes90(c, hier_tile90, rays, gmats, gvecs, nullptr, (int)n_vecs, st,
                      [&](int grid, const BwdMaps& maps, const BwdRays& r, int nt) {
                        hier_tile90<<<grid, THREADS90, BWD_SMEM_BYTES, st>>>(
                            maps, c.P, c.sc.s, c.sc.gates, r, ha, demb);
                        hier_losses<<<1, 64, 0, st>>>(c.sc.s.part, 2 * nt, c.sc.s.nv, loss);
                      });
}
