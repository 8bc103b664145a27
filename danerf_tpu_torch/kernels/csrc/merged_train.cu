// K4: the hierarchical fine pass of training -- field at the importance
// depths, rank merge with the coarse samples, composite over Sc + Sf, the
// MSE against the target over the batch's rays, and the whole backward in
// one call; the merged forward is never recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _merged_train_kernel (reached
// via _merged_train_pallas's pallas_call).
//
// Bound on an H100: operations.  The field runs once at Sf samples a ray
// (527,872 MACs a sample) and its transposed chain is 1,024,128 MACs a
// sample: ~3 forward units, 13.0 TFLOP per 65,536-ray chunk at Sf = 64
// (13.2 ms at 989 TFLOP/s bf16 dense), 0.21 ms for a 1024-ray batch.
// Per-ray HBM traffic is ~1.7 KB in (field_c is 1 KB of it) and ~1.2 KB out
// (g_field); the residual scratch adds ~9.5 KB a fine-sample row
// (field_bwd.cuh).
//
// Design: the merge is K5's per-ray counting (field.cuh merge_ray: rank_c =
// i + #{z_f < z_c[i]}, rank_f = j + #{z_c <= z_f[j]}, coarse first on ties),
// and the ranks are kept so that the un-permute is the inverse gather by
// them (the TPU's transposed one-hot matmuls are not carried over): coarse
// ranks give g_field (R,4,Sc), fine ranks the per-row cotangents of the
// fine field.
// The loss masks the ragged edge by processing only rays < R; it is summed
// per tile and then in tile order.  Residuals and the deterministic
// gradient reduction are field_bwd.cuh's.
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf),
//        target (R,3) f32
//   out: gmats, gvecs (added to), demb (R,E), g_field (R,4,Sc), loss (added to)

#include "field_bwd.cuh"

using namespace danerf;

__global__ void __launch_bounds__(THREADS, 1)
merged_train_kernel(const FieldArgs P, const BwdWeights W, const Scratch sc,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ emb, const float* __restrict__ zc,
                    const float* __restrict__ fc, const float* __restrict__ zf,
                    const float* __restrict__ target, long long R, int Sc, int Sf, int rpc,
                    long long ray_base, float inv_denom, float* __restrict__ demb,
                    float* __restrict__ gfield) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(smem_raw + sizeof(Smem));
  const int Sa = Sc + Sf;
  float* cscr = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + sizeof(BwdSmem));
  float* zc_s = cscr + WARPS * 3 * Sa;        // rpc x Sc
  float* mz = zc_s + rpc * Sc;                // rpc x Sa
  float* msig = mz + rpc * Sa;                // rpc x Sa
  float* mrgb = msig + rpc * Sa;              // rpc x Sa x 3
  int* rank_c = reinterpret_cast<int*>(mrgb + rpc * Sa * 3);  // rpc x Sc
  int* rank_f = rank_c + rpc * Sc;                             // rpc x Sf
  const int tile = blockIdx.x;
  const long long ray0 = ray_base + (long long)tile * rpc;
  const int nvalid = (int)(R - ray0 < rpc ? R - ray0 : rpc);

  load_rays(sm, o, d, emb, P.emb_dim, ray0, rpc, R);
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / Sf;
    const long long r = ray0 + j;
    sm.z[row] = (j < rpc && r < R) ? zf[r * Sf + (row - j * Sf)] : 0.f;
    bs.g_sig[row] = 0.f;
    bs.g_rgb[row * 3 + 0] = 0.f; bs.g_rgb[row * 3 + 1] = 0.f; bs.g_rgb[row * 3 + 2] = 0.f;
  }
  for (int idx = threadIdx.x; idx < rpc * Sc; idx += THREADS) {
    const long long r = ray0 + idx / Sc;
    zc_s[idx] = r < R ? zc[r * Sc + idx % Sc] : 0.f;
  }
  if (threadIdx.x < MAX_RPC) bs.loss[threadIdx.x] = 0.f;
  __syncthreads();
  encode_tile(P, sm, Sf, rpc);
  __syncthreads();
  const Stash st{sc.h, sc.encx, sc.encd, sc.happ, sc.dirg, sc.rows * HID,
                 (long long)tile * TILE_M};
  __nv_bfloat16* cur = field_tile(P, sm, Sf, rpc, &st);
  __nv_bfloat16* nxt = cur == sm.hA ? sm.hB : sm.hA;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nvalid; j += WARPS) {
    const long long r = ray0 + j;
    float* mzj = mz + j * Sa;
    float* msj = msig + j * Sa;
    float* mrj = mrgb + j * Sa * 3;
    int* rcj = rank_c + j * Sc;
    int* rfj = rank_f + j * Sf;
    merge_ray(sm, zc_s + j * Sc, Sc, sm.z + j * Sf, Sf, fc + r * 4 * Sc, j * Sf, mzj, msj, mrj,
              rcj, rfj);
    float* al = cscr + warp * 3 * Sa;
    float out[5];
    composite_keep(mzj, msj, mrj, Sa, al, al + Sa, al + 2 * Sa, out);
    const float d0 = out[0] - target[r * 3 + 0];
    const float d1 = out[1] - target[r * 3 + 1];
    const float d2 = out[2] - target[r * 3 + 2];
    if (lane == 0) bs.loss[j] = (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom;
    const float k2 = 2.f * inv_denom;
    // the fine MSE reads only rgb: zero depth/acc/weights cotangents
    composite_bwd(mzj, mrj, Sa, al, al + Sa, al + 2 * Sa, out[3], out[4], k2 * d0, k2 * d1,
                  k2 * d2, 0.f, 0.f, nullptr, mrj, msj);
    __syncwarp();
    float* gf = gfield + r * 4 * Sc;
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
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int j = 0; j < nvalid; ++j) l += bs.loss[j];
    sc.part[(long long)tile * sc.nv + sc.nv - 1] = l;
  }
  field_bwd_tile(P, W, sm, bs, sc, tile, Sf, rpc, nvalid, cur, nxt, demb + ray0 * P.emb_dim);
}

extern "C" int danerf_merged_train(const float* o, const float* d, const float* emb,
                                   const float* zc, const float* fc, const float* zf,
                                   const float* target, long long R, long long Sc, long long Sf,
                                   long long E, float* gmats, float* gvecs, float* demb,
                                   float* gfield, float* loss, const void* mats,
                                   const float* vecs, const long long* meta, long long n_meta,
                                   const void* mats_t, const long long* meta_t,
                                   long long n_meta_t, void* scratch, long long scratch_bytes,
                                   long long n_vecs, void* stream) {
  if (Sc < 1 || Sc + Sf > 256) return ERR_SHAPE;
  BwdCall c;
  const int err = bwd_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, Sf, scratch,
                            scratch_bytes, n_vecs, &c);
  if (err || R == 0) return err;
  const int Sa = (int)(Sc + Sf);
  const size_t smem = bwd_smem_bytes(Sa) + sizeof(float) * c.rpc * (Sc + 5 * Sa) +
                      sizeof(int) * c.rpc * Sa;
  const float inv_denom = 1.f / (float)(R * 3.0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_passes(c, reinterpret_cast<const void*>(merged_train_kernel), smem, gmats, gvecs,
                    loss, (int)n_vecs, st, [&](int nt, long long ray_base) {
                      merged_train_kernel<<<nt, THREADS, smem, st>>>(
                          c.P, c.W, c.sc, o, d, emb, zc, fc, zf, target, R, (int)Sc, (int)Sf,
                          c.rpc, ray_base, inv_denom, demb, gfield);
                    });
}
