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
// passes (~9.5 KB a sample row, field_bwd.cuh).
//
// Design.  A CTA owns rpc rays, rpc = rays_per_tile(max(Sc, Sf)), and two
// virtual tiles of the scratch: 2b for its coarse rows (rpc x Sc) and 2b + 1
// for its fine rows (rpc x Sf), since field_bwd_tile indexes the stash rows
// and the row-sum slot by its tile and assigns both.  Pass 2 (finish_pass)
// then reduces the dW of both row sets in one deterministic GEMM pass, and
// hier_losses sums the fine and the coarse loss slots apart, in tile order.
//   1. Coarse forward: encode, field_tile (stash at tile 2b).  The coarse
//      rgb / sigma / sigma_pre of the tile's rays are kept in shared memory:
//      the fine forward overwrites Smem.
//   2. One warp per ray: the coarse composite, then the inverse CDF of its
//      weights (inverse_cdf): a warp prefix sum over Sc instead of the TPU's
//      triangular matmul, and a count #{cdf < u} per uniform for its
//      bracket, as merge_ray counts ranks instead of the one-hot matmuls.
//   3. Fine forward at the new depths (stash at tile 2b + 1), merge_ray with
//      the kept coarse field, composite, the fine MSE, the composite's
//      transpose, the un-permute (coarse ranks to the coarse field's
//      cotangent, kept in shared memory; fine ranks to the fine rows), and
//      the fine rows' transposed chain.
//   4. Coarse backward on the stashed coarse residuals, no MLP recompute:
//      the last trunk layer reloaded from the stash, the cheap coarse
//      composite recomputed from the kept field, its transpose under the
//      coarse MSE's cotangent times coarse_loss_weight, plus step 3's
//      coarse-field cotangent; the transposed chain, its demb added to the
//      fine one.
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), u (R,Sf), target (R,3) f32
//        [, t (R) with use_time]; cw = coarse_loss_weight
//   out: gmats, gvecs (packed-layout f32 gradients of mse_f + cw mse_c,
//        added to), demb (R,E), loss[0] = mse_f, loss[1] = mse_c (added to)

#include "field_bwd.cuh"
#include "bwd_tiles.cuh"

using namespace danerf;

namespace danerf {

// K9's per-ray arrays in shared memory, after Smem | BwdSmem | the per-warp
// composite scratch of Sa = Sc + Sf samples.
struct HierSmem {
  float* zc;     // rpc x Sc coarse depths
  float* zf;     // rpc x Sf fine depths (the inverse CDF's output)
  float* kf;     // rpc x 4 x Sc coarse field [r, g, b, sigma] (K2's field layout)
  float* ksp;    // rpc x Sc coarse sigma_pre
  float* gfc;    // rpc x 4 x Sc the coarse field's cotangent from the merged composite
  float* mz;     // rpc x Sa merged depths
  float* msig;   // rpc x Sa merged sigma, then its cotangent
  float* mrgb;   // rpc x Sa x 3 merged rgb, then its cotangent
  float* dembc;  // rpc x E the coarse pass's demb
  int* rank_c;   // rpc x Sc
  int* rank_f;   // rpc x Sf
};

// Lay the arrays out from base (or only measure them, base == nullptr);
// returns their bytes (every element is 4 bytes).
__host__ __device__ inline size_t hier_layout(unsigned char* base, int Sc, int Sf, int rpc, int E,
                                              HierSmem* h) {
  const int Sa = Sc + Sf;
  size_t off = 0;
  auto take = [&](int n) -> unsigned char* {
    unsigned char* p = base ? base + off : nullptr;
    off += 4 * (size_t)n;
    return p;
  };
  h->zc = reinterpret_cast<float*>(take(rpc * Sc));
  h->zf = reinterpret_cast<float*>(take(rpc * Sf));
  h->kf = reinterpret_cast<float*>(take(rpc * 4 * Sc));
  h->ksp = reinterpret_cast<float*>(take(rpc * Sc));
  h->gfc = reinterpret_cast<float*>(take(rpc * 4 * Sc));
  h->mz = reinterpret_cast<float*>(take(rpc * Sa));
  h->msig = reinterpret_cast<float*>(take(rpc * Sa));
  h->mrgb = reinterpret_cast<float*>(take(rpc * Sa * 3));
  h->dembc = reinterpret_cast<float*>(take(rpc * E));
  h->rank_c = reinterpret_cast<int*>(take(rpc * Sc));
  h->rank_f = reinterpret_cast<int*>(take(rpc * Sf));
  return off;
}

inline size_t hier_smem_bytes(int Sc, int Sf, int rpc, int E) {
  HierSmem h;
  return bwd_smem_bytes(Sc + Sf) + hier_layout(nullptr, Sc, Sf, rpc, E, &h);
}

// The inverse CDF of one ray's n weights w at its m uniforms u, by one warp,
// with ops/sampling.sample_pdf's arithmetic: wn = (w + 1e-5) / sum(w + 1e-5);
// cdf = [0, inclusive prefix sum of wn] (n + 1 values into cdf; a scan over
// the lanes' chunks); the bracket of u is inds = #{cdf < u} (searchsorted,
// right=False); cdf_above is +max-float past the end, z_above clamped into
// range, and a bracket narrower than 1e-5 gets a denominator of 1.  Writes
// z_out (m), sorted when u is increasing.
__device__ void inverse_cdf(const float* z, const float* w, int n, const float* __restrict__ u,
                            int m, float* cdf, float* z_out) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int s0 = min(n, lane * chunk), s1 = min(n, s0 + chunk);
  float part = 0.f;
  for (int s = s0; s < s1; ++s) part += w[s] + 1e-5f;
  const float total = warp_sum(part);
  float run = 0.f;
  for (int s = s0; s < s1; ++s) run += (w[s] + 1e-5f) / total;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float c = incl - run;  // the sum over the samples of earlier lanes
  if (lane == 0) cdf[0] = 0.f;
  for (int s = s0; s < s1; ++s) {
    c += (w[s] + 1e-5f) / total;
    cdf[s + 1] = c;
  }
  __syncwarp();
  const float big = 3.402823466e38f;  // f32 max
  for (int i = lane; i < m; i += 32) {
    const float ui = u[i];
    int inds = 0;
    for (int k = 0; k <= n; ++k) inds += cdf[k] < ui;
    const float below = cdf[max(inds - 1, 0)];
    const float above = inds <= n ? cdf[inds] : big;
    const float zb = z[max(min(inds, n) - 1, 0)];
    const float za = z[min(inds, n - 1)];
    float denom = above - below;
    if (denom < 1e-5f) denom = 1.f;
    const float tt = (ui - below) / denom;
    z_out[i] = zb + tt * (za - zb);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1)
hier_tile(const FieldArgs P, const BwdWeights W, const Scratch sc, const float* __restrict__ o,
          const float* __restrict__ d, const float* __restrict__ emb,
          const float* __restrict__ zc, const float* __restrict__ u,
          const float* __restrict__ target, const float* __restrict__ t, long long R, int Sc,
          int Sf, int rpc, long long ray_base, float inv_denom, float kc,
          float* __restrict__ demb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(smem_raw + sizeof(Smem));
  const int Sa = Sc + Sf, E = P.emb_dim;
  float* cscr = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + sizeof(BwdSmem));
  HierSmem h;
  hier_layout(reinterpret_cast<unsigned char*>(cscr + WARPS * 3 * Sa), Sc, Sf, rpc, E, &h);
  const int tile_c = 2 * blockIdx.x, tile_f = tile_c + 1;  // virtual tiles of the scratch
  const long long ray0 = ray_base + (long long)blockIdx.x * rpc;
  const int nvalid = (int)(R - ray0 < rpc ? R - ray0 : rpc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* al = cscr + warp * 3 * Sa;  // the warp's composite scratch: alpha, T, w

  // 1. the coarse forward, residuals stashed at tile_c; keep the field
  load_rays(sm, o, d, emb, t, E, ray0, rpc, R);
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / Sc;
    const long long r = ray0 + j;
    sm.z[row] = (j < rpc && r < R) ? zc[r * Sc + (row - j * Sc)] : 0.f;
  }
  for (int idx = threadIdx.x; idx < rpc * Sc; idx += THREADS) {
    const long long r = ray0 + idx / Sc;
    h.zc[idx] = r < R ? zc[r * Sc + idx % Sc] : 0.f;
  }
  __syncthreads();
  encode_tile(P, sm, Sc, rpc);
  __syncthreads();
  const Stash st_c{sc.h, sc.encx, sc.encd, sc.happ, sc.dirg, sc.rows * HID,
                   (long long)tile_c * TILE_M};
  field_tile(P, sm, Sc, rpc, &st_c);
  for (int idx = threadIdx.x; idx < rpc * Sc; idx += THREADS) {
    const int j = idx / Sc, i = idx - j * Sc;
    float* f = h.kf + j * 4 * Sc;
    f[i] = sm.rgb[idx * 3 + 0];
    f[Sc + i] = sm.rgb[idx * 3 + 1];
    f[2 * Sc + i] = sm.rgb[idx * 3 + 2];
    f[3 * Sc + i] = sm.sigma[idx];
    h.ksp[idx] = sm.sigma_pre[idx];
  }

  // 2. the coarse composite and the inverse CDF of its weights
  for (int j = warp; j < nvalid; j += WARPS) {
    float out[5];
    composite_keep(h.zc + j * Sc, sm.sigma + j * Sc, sm.rgb + j * Sc * 3, Sc, al, al + Sa,
                   al + 2 * Sa, out);
    __syncwarp();
    inverse_cdf(h.zc + j * Sc, al + 2 * Sa, Sc, u + (ray0 + j) * Sf, Sf, al, h.zf + j * Sf);
  }
  __syncthreads();

  // 3. the fine forward at the new depths (stash at tile_f), the merged
  //    composite, the fine MSE and its backward
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    sm.z[row] = row / Sf < nvalid ? h.zf[row] : 0.f;
    bs.g_sig[row] = 0.f;
    bs.g_rgb[row * 3 + 0] = 0.f; bs.g_rgb[row * 3 + 1] = 0.f; bs.g_rgb[row * 3 + 2] = 0.f;
  }
  __syncthreads();
  encode_tile(P, sm, Sf, rpc);
  __syncthreads();
  const Stash st_f{sc.h, sc.encx, sc.encd, sc.happ, sc.dirg, sc.rows * HID,
                   (long long)tile_f * TILE_M};
  __nv_bfloat16* cur = field_tile(P, sm, Sf, rpc, &st_f);
  __nv_bfloat16* nxt = cur == sm.hA ? sm.hB : sm.hA;
  const RayCot cot{target, inv_denom, nullptr, nullptr, nullptr, nullptr};
  for (int j = warp; j < nvalid; j += WARPS) {
    const long long r = ray0 + j;
    float* mzj = h.mz + j * Sa;
    float* msj = h.msig + j * Sa;
    float* mrj = h.mrgb + j * Sa * 3;
    int* rcj = h.rank_c + j * Sc;
    int* rfj = h.rank_f + j * Sf;
    merge_ray(sm, h.zc + j * Sc, Sc, sm.z + j * Sf, Sf, h.kf + j * 4 * Sc, j * Sf, mzj, msj, mrj,
              rcj, rfj);
    float out[5], g[5];
    const float* gw;
    composite_keep(mzj, msj, mrj, Sa, al, al + Sa, al + 2 * Sa, out);
    ray_cotangents<true>(cot, r, Sa, out, g, &gw, bs.loss + j);
    // the transpose overwrites the merged rgb / sigma with their cotangents
    composite_bwd(mzj, mrj, Sa, al, al + Sa, al + 2 * Sa, out[3], out[4], g[0], g[1], g[2],
                  g[3], g[4], gw, mrj, msj);
    __syncwarp();
    // un-permute: the inverse gather by the kept ranks
    float* gf = h.gfc + j * 4 * Sc;
    for (int i = lane; i < Sc; i += 32) {
      const int k = rcj[i];
      gf[i] = mrj[k * 3 + 0];
      gf[Sc + i] = mrj[k * 3 + 1];
      gf[2 * Sc + i] = mrj[k * 3 + 2];
      gf[3 * Sc + i] = msj[k];
    }
    for (int i = lane; i < Sf; i += 32) {
      const int k = rfj[i];
      const int row = j * Sf + i;
      bs.g_rgb[row * 3 + 0] = mrj[k * 3 + 0];
      bs.g_rgb[row * 3 + 1] = mrj[k * 3 + 1];
      bs.g_rgb[row * 3 + 2] = mrj[k * 3 + 2];
      bs.g_sig[row] = msj[k];
    }
  }
  __syncthreads();
  store_tile_loss<true>(bs, sc, tile_f, nvalid);
  field_bwd_tile(P, W, sm, bs, sc, tile_f, Sf, rpc, nvalid, cur, nxt, demb + ray0 * E);
  __syncthreads();

  // 4. the coarse backward on the stashed coarse residuals: restore the
  //    kept field and the last trunk layer's output, recompute the coarse
  //    composite, transpose it under cw x the coarse MSE's cotangent, add
  //    the coarse field's cotangent of step 3
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / Sc, i = row - j * Sc;
    const bool ok = j < rpc;
    const float* f = h.kf + (ok ? j : 0) * 4 * Sc;
    sm.rgb[row * 3 + 0] = ok ? f[i] : 0.f;
    sm.rgb[row * 3 + 1] = ok ? f[Sc + i] : 0.f;
    sm.rgb[row * 3 + 2] = ok ? f[2 * Sc + i] : 0.f;
    sm.sigma[row] = ok ? f[3 * Sc + i] : 0.f;
    sm.sigma_pre[row] = ok ? h.ksp[row] : 0.f;
    bs.g_sig[row] = 0.f;
    bs.g_rgb[row * 3 + 0] = 0.f; bs.g_rgb[row * 3 + 1] = 0.f; bs.g_rgb[row * 3 + 2] = 0.f;
  }
  const __nv_bfloat16* h_last =
      sc.h + (long long)(P.num_layers - 1) * sc.rows * HID + (long long)tile_c * TILE_M * HID;
  for (int idx = threadIdx.x; idx < TILE_M * (HID / 8); idx += THREADS) {
    const int r = idx / (HID / 8), c = (idx - r * (HID / 8)) * 8;
    *reinterpret_cast<uint4*>(sm.hA + r * LDH + c) =
        *reinterpret_cast<const uint4*>(h_last + (long long)r * HID + c);
  }
  __syncthreads();
  for (int j = warp; j < nvalid; j += WARPS) {
    const long long r = ray0 + j;
    float out[5];
    composite_keep(h.zc + j * Sc, sm.sigma + j * Sc, sm.rgb + j * Sc * 3, Sc, al, al + Sa,
                   al + 2 * Sa, out);
    const float d0 = out[0] - target[r * 3 + 0];
    const float d1 = out[1] - target[r * 3 + 1];
    const float d2 = out[2] - target[r * 3 + 2];
    if (lane == 0) bs.loss[j] = (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom;
    composite_bwd(h.zc + j * Sc, sm.rgb + j * Sc * 3, Sc, al, al + Sa, al + 2 * Sa, out[3], out[4],
                  kc * d0, kc * d1, kc * d2, 0.f, 0.f, nullptr, bs.g_rgb + j * Sc * 3,
                  bs.g_sig + j * Sc);
    __syncwarp();
    const float* gf = h.gfc + j * 4 * Sc;
    for (int s = lane; s < Sc; s += 32) {
      const int row = j * Sc + s;
      bs.g_rgb[row * 3 + 0] += gf[s];
      bs.g_rgb[row * 3 + 1] += gf[Sc + s];
      bs.g_rgb[row * 3 + 2] += gf[2 * Sc + s];
      bs.g_sig[row] += gf[3 * Sc + s];
    }
  }
  __syncthreads();
  store_tile_loss<true>(bs, sc, tile_c, nvalid);
  field_bwd_tile(P, W, sm, bs, sc, tile_c, Sc, rpc, nvalid, sm.hA, sm.hB, h.dembc);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nvalid * E; idx += THREADS)
    demb[ray0 * E + idx] += h.dembc[idx];
}

// The two losses of a pass: loss[0] += the fine slots (odd virtual tiles),
// loss[1] += the coarse slots (even ones), each summed in tile order.
__global__ void hier_losses(const float* __restrict__ part, int vtiles, int nv,
                            float* __restrict__ loss) {
  const int k = threadIdx.x;
  if (k > 1) return;
  float s = 0.f;
  for (int v = 1 - k; v < vtiles; v += 2) s += part[(long long)v * nv + nv - 1];
  loss[k] += s;
}

// Virtual tiles of one pass: two per CTA, within MAX_TILES_PER_PASS.
inline long long hier_tiles_pass(long long ctas) {
  return ctas < MAX_TILES_PER_PASS / 2 ? ctas : MAX_TILES_PER_PASS / 2;
}

}  // namespace danerf

// Bytes of scratch K9 needs for R rays of s = max(Sc, Sf) samples a tile
// row group: the residuals of both row sets of every CTA of one pass;
// negative on a malformed layout.
extern "C" long long danerf_hier_onepass_scratch_bytes(const long long* meta, long long n_meta,
                                                       long long R, long long s, long long n_vecs) {
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  if (s < 1 || s > TILE_M || R < 0) return ERR_SHAPE;
  const int rpc = rays_per_tile(s);
  Scratch sc;
  return carve(nullptr, P, 2 * hier_tiles_pass((R + rpc - 1) / rpc), (int)n_vecs, &sc);
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
  BwdCall c;
  int err = bwd_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R,
                      Sc > Sf ? Sc : Sf, scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  c.tiles_pass = (int)hier_tiles_pass(c.tiles_total);
  if (carve(static_cast<char*>(scratch), c.P, 2LL * c.tiles_pass, (int)n_vecs, &c.sc) >
      scratch_bytes)
    return ERR_SHAPE;
  const size_t smem = hier_smem_bytes((int)Sc, (int)Sf, c.rpc, c.P.emb_dim);
  if (smem > 232448) return ERR_SHAPE;
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(hier_tile),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_denom = 1.f / (float)(R * 3.0);
  const float kc = (float)(2.0 * cw / (R * 3.0));
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    e = cudaMemsetAsync(c.sc.part, 0, sizeof(float) * 2 * nt * c.sc.nv, st);
    if (e != cudaSuccess) return (int)e;
    hier_tile<<<nt, THREADS, smem, st>>>(c.P, c.W, c.sc, o, d, emb, zc, u, target, t, R, (int)Sc,
                                         (int)Sf, c.rpc, t0 * c.rpc, inv_denom, kc, demb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    hier_losses<<<1, 32, 0, st>>>(c.sc.part, 2 * nt, c.sc.nv, loss);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    err = finish_pass(c.P, c.sc, 2 * nt, gmats, gvecs, nullptr, (int)n_vecs, st);
    if (err) return err;
  }
  return 0;
}
