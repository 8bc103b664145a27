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
// Design (bwd_tiles.cuh merged_tile, shared with K6 with the cotangents
// formed from the MSE): the merge is K5's per-ray counting (field.cuh merge_ray: rank_c =
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
#include "bwd_tiles.cuh"

using namespace danerf;

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
  const size_t smem = merged_smem_bytes((int)Sc, (int)Sf, c.rpc);
  const RayCot cot{target, 1.f / (float)(R * 3.0), nullptr, nullptr, nullptr, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_passes(c, reinterpret_cast<const void*>(merged_tile<true>), smem, gmats, gvecs,
                    loss, (int)n_vecs, st, [&](int nt, long long ray_base) {
                      merged_tile<true><<<nt, THREADS, smem, st>>>(
                          c.P, c.W, c.sc, o, d, emb, zc, fc, zf, R, (int)Sc, (int)Sf, c.rpc,
                          ray_base, cot, demb, gfield);
                    });
}
