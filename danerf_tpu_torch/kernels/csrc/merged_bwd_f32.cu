// K6 in f32 (use_bf16=False): the VJP of the merged composite (K5) --
// recompute the field at the importance depths and the rank merge,
// transpose the composite over Sc + Sf with the caller's cotangents of rgb,
// depth, acc and the merged weights, un-permute to the coarse field's
// cotangent and the fine rows, and run the fine rows' transposed MLP, every
// product and residual in f32.
//
// Replaces danerf_tpu/kernels/fused_render.py _merged_bwd_kernel (reached
// via _hier_vjp_bwd's pallas_call) under cfg.use_bf16 = False, which
// training takes for a white background (and, with has_time, for
// use_time), and eval's embedding fit.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s (FFMA, no tensor core).
// The field is recomputed at Sf samples a ray (527,872 MACs a sample) and
// its transposed chain is 1,024,128 MACs a sample: 1,552,000 a sample, 3.04
// ms for a 1024-ray batch at Sf = 64, 24.3 ms at 8,192 rays.  Per-ray HBM
// traffic is ~2.2 KB in (field_c 1 KB, g_w 0.5 KB) and ~1.2 KB out
// (g_field); the f32 stash adds ~18 KB a fine-sample row.
//
// Design (csrc/field_bwd_f32.cuh, K4's f32 tile and merged composite with
// the caller's cotangents instead of the MSE's, and no loss): the depth
// cotangent goes through the recomputed merged depth and acc; a null
// cotangent reads as zeros (the white background hands only g_rgb and
// g_acc).  It takes the bf16 K6's shapes (bwd_tiles.cuh merged_smem_bytes;
// Sc >= 1, Sf >= 1, Sc + Sf <= 256).
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf) f32
//        [, t (R) with use_time];
//        cotangents g_rgb (R,3), g_depth, g_acc (R), g_w (R,Sc+Sf), each
//        optional (null reads as zeros); mats, mats_t, meta_t as K3's f32
//        entry
//   out: gmats, gvecs (added to), demb (R,E), g_field (R,4,Sc)

#include "field_bwd_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

extern "C" int danerf_merged_bwd_f32(const float* o, const float* d, const float* emb,
                                     const float* zc, const float* fc, const float* zf,
                                     const float* t, long long R, long long Sc, long long Sf,
                                     long long E, const float* g_rgb, const float* g_depth,
                                     const float* g_acc, const float* g_w, float* gmats,
                                     float* gvecs, float* demb, float* gfield, const void* mats,
                                     const float* vecs, const long long* meta, long long n_meta,
                                     const void* mats_t, const long long* meta_t,
                                     long long n_meta_t, void* scratch, long long scratch_bytes,
                                     long long n_vecs, void* stream) {
  if (Sc < 1 || Sc + Sf > 256) return ERR_SHAPE;
  Bwd32Call c;
  const int err = bwd32_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, Sf,
                              scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  if (merged_smem_bytes((int)Sc, (int)Sf, c.rpc) > 232448) return ERR_SHAPE;
  const MergedComp32<false> comp{{nullptr, 0.f, g_rgb, g_depth, g_acc, g_w},
                                 zc, fc, gfield, R, (int)Sc, (int)Sf};
  const Rays32 rays{o, d, emb, t, zf, nullptr, nullptr, R, 0, (int)Sf, c.rpc, 0};
  return run_bwd32(c, comp, rays, gmats, gvecs, nullptr, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
