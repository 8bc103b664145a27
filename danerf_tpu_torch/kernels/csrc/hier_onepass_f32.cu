// K9 in f32 (use_bf16=False): the whole hierarchical training step in one
// call -- the coarse march at z_c keeping its field and its residuals, the
// inverse CDF of the coarse weights at the given uniforms u, the
// rank-merged fine pass over the kept coarse field, both MSE terms, and
// the backward of both passes, every trunk, dir-layer, transposed-chain and
// dW product by 3xTF32 on the tensor cores; the coarse forward is never
// recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _hier_onepass_kernel (reached
// via _hier_onepass_pallas's pallas_call) under cfg.use_bf16 = False, with
// and without time.
//
// Bound on an H100: operations.  The field runs once at the Sc coarse and
// once at the Sf fine samples of a ray (527,872 MACs a sample) and its
// transposed chain once at each (1,024,128 MACs a sample): (Sc + Sf) x
// 1,552,000 MACs a ray; with the trunk and dir-layer products, their
// transposes and their dW three TF32 products each, 2.46 ms for a 1024-ray
// batch of 64 + 64 at TF32's 494.7 TFLOP/s (6.07 ms at FP32's 67).  The two
// gate passes add the forward once more on the CUDA cores (~2.1 ms at
// FP32's 67).  Per-ray HBM traffic is ~0.7 KB in and 0.13 KB out; the stash
// holds the rows of both row sets (~26 KB a sample row, ~3.4 GB at that
// batch, written and read back once: ~2 ms at 3.35 TB/s).
//
// Design (csrc/field_bwd_f32_sm90.cuh: field_f32_sm90.cuh's tensor-core
// tile with its stash hooks, the gate pass, the merged composite
// MergedComp32, the chain and the wgmma dW pass).  The relu gates must be
// an f32 forward's (the gate pass on the CUDA cores), and the fine rows'
// depths are known only once the coarse weights are, so the step runs in
// launches: a tile is rpc rays, rpc = rays_per_tile(max(Sc, Sf)), and two
// virtual tiles of the stash, 2b for its coarse rows (rpc x Sc) and 2b + 1
// for its fine rows (rpc x Sf), each with its stash rows, row-sum slots and
// gate records.  Per pass of at most MAX_TILES_PASS32 / 2 tiles:
//   1. The gate pass on the coarse rows (records at 2b).
//   2. hier_coarse32: the coarse forward on those gates (stash at 2b); the
//      coarse field [r, g, b, sigma] and sigma_pre kept in the scratch
//      (Kept32: written and read by the same CTA, L2-resident, ~2.6 MB at
//      a 1024-ray batch of 64 + 64 with the merge's cotangent: the tile's
//      shared memory has no room for them);
//      one warp per ray, the coarse composite and the inverse CDF of its f32
//      weights (bwd_tiles.cuh inverse_cdf; their arrays in the activation
//      buffer, idle after the forward), the fine depths z_f to the scratch.
//   3. The gate pass on the fine rows at z_f (records at 2b + 1).
//   4. hier_fine32: the fine forward (stash at 2b + 1); the merged
//      composite in the weight ring (merged with the kept coarse field,
//      composite, fine MSE, transpose, un-permute: coarse ranks to the
//      coarse field's cotangent, kept in the scratch; fine ranks to the fine
//      rows); the fine chain, each ray's d_happ summed; then the coarse
//      backward on the stashed coarse residuals, no MLP recompute: the kept
//      field restored, the coarse composite recomputed and transposed (in
//      the activation buffer, between the two chains) under cw x the coarse
//      MSE's cotangent, plus the merge's cotangent of the coarse field; the
//      coarse chain (its head reads the last coarse trunk output back from
//      the stash), its d_happ added to the sums; each ray's demb = those
//      sums @ Wapp.  The producer streams the forward's weights, then the
//      transposed chain's twice.
//   5. One dW pass over both row sets (dw_t32_kernel, fixed 1,024-row
//      partitions summed in order; the narrow jobs on dw32_kernel); the row
//      sums summed in slot order.
//   6. hier_losses_of: the fine and the coarse loss slots apart, in tile
//      order.
// Every sum runs in a fixed order and nothing is added atomically, so two
// calls give bit-identical results.
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), u (R,Sf), target (R,3) f32
//        [, t (R) with use_time]; cw = coarse_loss_weight; the weights as
//        K3's f32 entry takes them
//   out: gmats, gvecs (packed-layout f32 gradients of mse_f + cw mse_c,
//        added to), demb (R,E), loss[0] = mse_f, loss[1] = mse_c (added to)

#include "field_bwd_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

// What K9 keeps between its launches, for the rays of one pass (ray r of
// the pass): its fine depths, its coarse field [r, g, b, sigma] in the
// (4, Sc) layout merged_ray32 reads, its coarse sigma_pre, and the merge's
// cotangent of the coarse field.
struct Kept32 {
  float* zf;   // R x Sf
  float* kf;   // R x 4 x Sc
  float* ksp;  // R x Sc
  float* gfc;  // R x 4 x Sc
};

// Lay the kept arrays out from base (or only measure them) for `rays` rays
// of at most s samples a row set; returns their bytes.
inline long long carve_kept(char* base, long long rays, long long s, Kept32* k) {
  long long off = 0;
  auto take = [&](long long floats) -> float* {
    float* p = base ? reinterpret_cast<float*>(base + off) : nullptr;
    off += (floats * (long long)sizeof(float) + 1023) / 1024 * 1024;
    return p;
  };
  k->zf = take(rays * s);
  k->kf = take(rays * 4 * s);
  k->ksp = take(rays * s);
  k->gfc = take(rays * 4 * s);
  return off;
}

// K9's arguments beyond the rays, for one pass: its coarse depths (R, Sc)
// and targets (R, 3) from the pass's first ray on, 1 / (3R) and cw x 2 /
// (3R) of the launch's R.
struct HierT32 {
  const float* zc;
  const float* target;
  float inv_denom, kc;
  int Sc, Sf;
};

// Every shape K9 takes (Sc, Sf in 1..128, rpc = rays_per_tile(max(Sc, Sf))):
// the merged composite's arrays (MergedComp32: the per-warp alpha / T / w,
// the tile's coarse depths, each ray's merge arrays) fit in the weight
// ring, the coarse composite's per-warp arrays in the activation buffer.
constexpr bool hier_t32_fits() {
  for (int s = 1; s <= TILE_M; ++s) {
    const int rpc = TILE_M / s < MAX_RPC ? TILE_M / s : MAX_RPC, sa = 2 * s;  // rays_per_tile
    if ((f32::COMP_THREADS / 32) * 3 * sa + rpc * s + rpc * 6 * sa >
        (int)(sizeof(Smem32::ring) / sizeof(float)))
      return false;
    if ((f32::COMP_THREADS / 32) * 3 * s > HID * ROWS) return false;
  }
  return true;
}
static_assert(hier_t32_fits(), "a K9 shape's composite arrays do not fit its f32 tile");

// Steps 2 (hier_coarse32) and 4 (hier_fine32) for each tile of this CTA:
// rays the pass's (coarse: z = z_c, s = Sc; fine: z = z_f, s = Sf), gates
// at sc.gates, tile b's row sets at virtual tiles 2b and 2b + 1.
__global__ void __launch_bounds__(THREADS, 1)
hier_coarse32(const __grid_constant__ BwdMapsT32 maps, const FieldArgs P,
              const float* __restrict__ W, const ScratchT32 sc, const Rays rays,
              const float* __restrict__ u, const Kept32 kp, int Sf) {
  SmemT32& sm = smem_t32();
  init32(sm.f);
  if (threadIdx.x >= CONSUMERS) {
    produce_bwd(maps, P, W, rays, StashEnc{P, sc, rays.emb, rays.R, rays.s, rays.rpc, 2, 0}, 0);
    return;
  }
  consumer_regs();
  const int Sc = rays.s, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles), L = P.num_layers;
  const int warp = threadIdx.x >> 5;
  Pipe pp;
  float acc[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long tile = blockIdx.x + (long long)c * gridDim.x, vc = 2 * tile;
    const long long ray0 = tile * rpc;
    const int nvalid = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    StashRes res{sc.hs, sc.happ, sc.gates + vc * (L + 1) * CONSUMERS, sm.sigma_pre, vc * ROWS,
                 sc.rows * HID, L};
    field_tile(P, W, sm.f, c, Sc, rpc, pp, acc, res);
    dead_acc(acc);
    // keep the coarse field and sigma_pre
    for (int idx = threadIdx.x; idx < nvalid * Sc; idx += CONSUMERS) {
      const int j = idx / Sc, i = idx - j * Sc;
      float* f = kp.kf + (ray0 + j) * 4 * Sc;
      f[i] = sm.f.rgb[idx * 3 + 0];
      f[Sc + i] = sm.f.rgb[idx * 3 + 1];
      f[2 * Sc + i] = sm.f.rgb[idx * 3 + 2];
      f[3 * Sc + i] = sm.f.sigma[idx];
      kp.ksp[(ray0 + j) * Sc + i] = sm.sigma_pre[idx];
    }
    // the coarse composite and the inverse CDF of its weights (their arrays
    // in the activation buffer, which field_tile's last barrier left idle)
    const float* zs = sm.f.tr[c & 1].z;
    for (int j = warp; j < nvalid; j += CONSUMERS / 32) {
      float* al = sm.f.act + warp * 3 * Sc;
      float out[5];
      composite_keep(zs + j * Sc, sm.f.sigma + j * Sc, sm.f.rgb + j * Sc * 3, Sc, al, al + Sc,
                     al + 2 * Sc, out);
      __syncwarp();
      inverse_cdf(zs + j * Sc, al + 2 * Sc, Sc, u + (ray0 + j) * Sf, Sf, al,
                  kp.zf + (ray0 + j) * Sf);
    }
    end_tile(sm.f, c);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
hier_fine32(const __grid_constant__ BwdMapsT32 maps, const FieldArgs P,
            const float* __restrict__ W, const ScratchT32 sc, const Rays rays, const HierT32 ha,
            const Kept32 kp, float* __restrict__ demb) {
  SmemT32& sm = smem_t32();
  if (threadIdx.x == 0) mbar_init(&sm.comp_done, 1);
  init32(sm.f);
  if (threadIdx.x >= CONSUMERS) {
    produce_bwd(maps, P, W, rays, StashEnc{P, sc, rays.emb, rays.R, rays.s, rays.rpc, 2, 1}, 2);
    return;
  }
  consumer_regs();
  const int Sc = ha.Sc, Sf = ha.Sf, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const int L = P.num_layers, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const f32::MergedComp32<true> comp{{ha.target, ha.inv_denom, nullptr, nullptr, nullptr, nullptr},
                                     ha.zc, kp.kf, kp.gfc, rays.R, Sc, Sf};
  BwdSmem& bs = sm.bs;
  Scratch sums{};  // store_tile_loss reads part and nv only
  sums.part = sc.part;
  sums.nv = sc.nv;
  Pipe pp;
  float acc[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long tile = blockIdx.x + (long long)c * gridDim.x, vc = 2 * tile, vf = vc + 1;
    const long long ray0 = tile * rpc;
    const int nvalid = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    const uint4* gin_c = sc.gates + vc * (L + 1) * CONSUMERS;
    const uint4* gin_f = sc.gates + vf * (L + 1) * CONSUMERS;
    for (int r = threadIdx.x; r < ROWS; r += CONSUMERS) {
      bs.g_sig[r] = 0.f;
      bs.g_rgb[r * 3 + 0] = 0.f;
      bs.g_rgb[r * 3 + 1] = 0.f;
      bs.g_rgb[r * 3 + 2] = 0.f;
    }

    // the fine forward, the merged composite with the fine MSE and its
    // transpose in the ring; the fine chain
    StashRes res{sc.hs, sc.happ, gin_f, sm.sigma_pre, vf * ROWS, sc.rows * HID, L};
    field_tile(P, W, sm.f, c, Sf, rpc, pp, acc, res);
    dead_acc(acc);
    comp(f32::CompTile<ConsumerSync>{sm.f.tr[c & 1].z, sm.f.sigma, sm.f.rgb, bs,
                                     reinterpret_cast<float*>(sm.f.ring), {}},
         ray0, nvalid, rpc);
    fence_proxy_async();  // the ring's generic writes before the producer's next loads
    consumers_sync();
    if (threadIdx.x == 0) {
      mbar_arrive(&sm.comp_done);
      mbar_arrive(&sm.f.tr_empty[c & 1]);
    }
    store_tile_loss<true>(bs, sums, (int)(SLOTS * vf), nvalid);
    float* slot = sc.part + (SLOTS * vf + warp) * sc.nv;
    chain_head<DEMB_KEEP>(P, W, sm, sc, vf * ROWS, slot, res.md, Sf, nvalid, ray0, demb);
    chain(P, sm, sc, gin_f, vf * ROWS, slot, pp, acc);

    // the coarse backward: the kept field restored, the coarse composite
    // recomputed and transposed under cw x the coarse MSE's cotangent, plus
    // the merge's cotangent of the coarse field (arrays in the activation
    // buffer: the fine chain is done with it); the coarse chain
    consumers_sync();  // every consumer is done with the fine chain's reads
    for (int row = threadIdx.x; row < ROWS; row += CONSUMERS) {
      const int j = row / Sc, i = row - j * Sc;
      const bool ok = j < nvalid;
      const float* f = kp.kf + (ray0 + (ok ? j : 0)) * 4 * Sc;
      sm.f.rgb[row * 3 + 0] = ok ? f[i] : 0.f;
      sm.f.rgb[row * 3 + 1] = ok ? f[Sc + i] : 0.f;
      sm.f.rgb[row * 3 + 2] = ok ? f[2 * Sc + i] : 0.f;
      sm.f.sigma[row] = ok ? f[3 * Sc + i] : 0.f;
      sm.sigma_pre[row] = ok ? kp.ksp[(ray0 + j) * Sc + i] : 0.f;
      bs.g_sig[row] = 0.f;
      bs.g_rgb[row * 3 + 0] = 0.f;
      bs.g_rgb[row * 3 + 1] = 0.f;
      bs.g_rgb[row * 3 + 2] = 0.f;
    }
    consumers_sync();
    for (int j = warp; j < nvalid; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      const float* zc = ha.zc + r * Sc;
      float* al = sm.f.act + warp * 3 * Sc;
      float out[5];
      composite_keep(zc, sm.f.sigma + j * Sc, sm.f.rgb + j * Sc * 3, Sc, al, al + Sc,
                     al + 2 * Sc, out);
      const float d0 = out[0] - ha.target[r * 3 + 0];
      const float d1 = out[1] - ha.target[r * 3 + 1];
      const float d2 = out[2] - ha.target[r * 3 + 2];
      if (lane == 0) bs.loss[j] = (d0 * d0 + d1 * d1 + d2 * d2) * ha.inv_denom;
      composite_bwd(zc, sm.f.rgb + j * Sc * 3, Sc, al, al + Sc, al + 2 * Sc, out[3], out[4],
                    ha.kc * d0, ha.kc * d1, ha.kc * d2, 0.f, 0.f, nullptr,
                    bs.g_rgb + j * Sc * 3, bs.g_sig + j * Sc);
      __syncwarp();
      const float* gf = kp.gfc + r * 4 * Sc;
      for (int i = lane; i < Sc; i += 32) {
        const int row = j * Sc + i;
        bs.g_rgb[row * 3 + 0] += gf[i];
        bs.g_rgb[row * 3 + 1] += gf[Sc + i];
        bs.g_rgb[row * 3 + 2] += gf[2 * Sc + i];
        bs.g_sig[row] += gf[3 * Sc + i];
      }
    }
    consumers_sync();
    store_tile_loss<true>(bs, sums, (int)(SLOTS * vc), nvalid);
    slot = sc.part + (SLOTS * vc + warp) * sc.nv;
    const uint4 md_c = __ldg(gin_c + L * CONSUMERS + threadIdx.x);
    chain_head<DEMB_ADD, true>(P, W, sm, sc, vc * ROWS, slot, md_c, Sc, nvalid, ray0, demb);
    chain(P, sm, sc, gin_c, vc * ROWS, slot, pp, acc);
  }
}

// Bytes of scratch K9 in f32 needs for R rays of s = max(Sc, Sf) samples a
// tile row group: the stash of both row sets of every tile of one pass,
// then the pass's kept arrays; negative on a malformed layout or a shape it
// does not take.
inline long long hier_t32_bytes(const FieldArgs& P, long long R, long long s, long long n_vecs,
                                long long* stash_bytes = nullptr) {
  const int units = tile_units_t32(s, false);
  if (units == 0 || R < 0) return ERR_SHAPE;
  long long tiles = 0;
  const long long bytes = stash_t32_bytes(P, R, units, 2, n_vecs, &tiles);
  if (stash_bytes != nullptr) *stash_bytes = bytes;
  Kept32 k;
  return bytes + carve_kept(nullptr, tiles * units, s, &k);
}

extern "C" long long danerf_hier_onepass_f32_scratch_bytes(const long long* meta,
                                                           long long n_meta, long long R,
                                                           long long s, long long n_vecs) {
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  return hier_t32_bytes(P, R, s, n_vecs);
}

// Step 6: the two losses of a pass, SLOTS row-sum slots a virtual tile.
__global__ void hier_losses32(const float* __restrict__ part, int vtiles, int nv,
                              float* __restrict__ loss) {
  hier_losses_of(part, vtiles, nv, SLOTS, loss);
}

extern "C" int danerf_hier_onepass_f32(const float* o, const float* d, const float* emb,
                                       const float* zc, const float* u, const float* target,
                                       const float* t, long long R, long long Sc, long long Sf,
                                       long long E, double cw, float* gmats, float* gvecs,
                                       float* demb, float* loss, const float* mats,
                                       const float* w_hi, const float* w_lo, const float* wt,
                                       const float* vecs, const long long* meta, long long n_meta,
                                       const float* wt_hi, const float* wt_lo,
                                       const long long* meta_t, long long n_meta_t,
                                       void* scratch, long long scratch_bytes, long long n_vecs,
                                       void* stream) {
  if (Sc < 1 || Sf < 1 || Sc > TILE_M || Sf > TILE_M) return ERR_SHAPE;
  const long long s = Sc > Sf ? Sc : Sf;
  BwdT32Call c;
  int err = parse_meta(meta, n_meta, nullptr, vecs, E, &c.P);
  if (err) return err;
  long long stash = 0;
  const long long total = hier_t32_bytes(c.P, R, s, n_vecs, &stash);
  if (total < 0) return (int)total;
  char* kept_at = nullptr;
  err = bwd_t32_setup(meta, n_meta, mats, w_hi, w_lo, wt, vecs, E, wt_hi, wt_lo, meta_t,
                      n_meta_t, R, s, scratch, scratch_bytes, n_vecs, &c, false, 2, total - stash,
                      &kept_at);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  if (hier_smem_bytes((int)Sc, (int)Sf, c.rpc, c.P.emb_dim) > 232448) return ERR_SHAPE;
  Kept32 kp;
  carve_kept(kept_at, (long long)c.tiles_pass * c.rpc, s, &kp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScratchT32& sc = c.sc;
  const int L = c.P.num_layers;
  BwdMapsT32 maps{};
  DwMapsT32 dm{};
  int n_sm = 0;
  if ((err = t32_maps(c, &maps, &dm, &n_sm))) return err;
  cudaError_t e = cudaFuncSetAttribute(hier_coarse32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)T32_SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(hier_fine32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T32_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const float inv_denom = 1.f / (float)(R * 3.0), kc = (float)(2.0 * cw / (R * 3.0));
  const Rays rays{o, d, emb, t, zc, nullptr, nullptr, R, 0, (int)Sc, c.rpc, 0};
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    e = cudaMemsetAsync(sc.part, 0, sizeof(float) * SLOTS * 2 * nt * sc.nv, st);
    if (e != cudaSuccess) return (int)e;
    const long long rb = t0 * c.rpc;
    const int grid = nt < n_sm ? nt : n_sm;
    // 1, 2: the coarse rows' gates, then their forward, composite and
    // inverse CDF
    const Rays rc = pass_rays(rays, rb, nt, E);
    if ((err = launch_gates<RAYS>(c, rc, sc.gates, 2, st))) return err;
    hier_coarse32<<<grid, THREADS, T32_SMEM_BYTES, st>>>(maps, c.P, c.w, sc, rc, u + Sf * rb, kp,
                                                         (int)Sf);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // 3, 4: the fine rows' gates at z_f, then the fine pass and both chains
    Rays rf = rc;
    rf.z = kp.zf;
    rf.s = (int)Sf;
    if ((err = launch_gates<RAYS>(c, rf, sc.gates + (L + 1) * CONSUMERS, 2, st))) return err;
    const HierT32 ha{zc + Sc * rb, target + 3 * rb, inv_denom, kc, (int)Sc, (int)Sf};
    hier_fine32<<<grid, THREADS, T32_SMEM_BYTES, st>>>(maps, c.P, c.w, sc, rf, ha, kp,
                                                       demb + E * rb);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // 5, 6: the dW pass over both row sets, the row sums and the losses
    if ((err = finish_t32(c, dm, 2 * nt, gmats, gvecs, nullptr, (int)n_vecs, st))) return err;
    hier_losses32<<<1, 64, 0, st>>>(sc.part, 2 * nt, sc.nv, loss);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
