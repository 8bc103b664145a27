// K4 in f32 (use_bf16=False): the hierarchical fine pass of training --
// field at the importance depths, rank merge with the coarse samples,
// composite over Sc + Sf, the MSE against the target over the batch's rays,
// and the whole backward in one call, every product by 3xTF32 on the
// tensor cores.
//
// Replaces danerf_tpu/kernels/fused_render.py _merged_train_kernel (reached
// via _merged_train_pallas's pallas_call) under cfg.use_bf16 = False, and
// its has_time variant.
//
// Bound on an H100: operations.  The field runs once at Sf samples a ray
// (527,872 MACs a sample) and its transposed chain is 1,024,128 MACs a
// sample: 1,552,000 a sample, three TF32 products each, 1.23 ms for a
// 1024-ray batch at Sf = 64 at TF32's 494.7 TFLOP/s (3.04 ms at FP32's 67),
// 9.87 ms at 8,192 rays; the gate pass adds the forward once more on the
// CUDA cores (1.03 ms at FP32's 67).  Per-ray HBM traffic is ~1.7 KB in
// (field_c is 1 KB of it) and ~1.2 KB out (g_field); the stash adds ~26 KB
// a fine-sample row.
//
// Design (csrc/field_bwd_f32_sm90.cuh, K3's f32 tile with the merged
// composite): the merge is field.cuh merge_ray's per-ray counting (coarse
// first on ties) and the un-permute the inverse gather by the same ranks:
// coarse ranks give g_field (R,4,Sc), fine ranks the per-row cotangents of
// the fine field.  The merge arrays live in the weight ring between the
// forward and the transposed chain.  It takes the bf16 K4's shapes
// (bwd_tiles.cuh merged_smem_bytes).
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf),
//        target (R,3) f32 [, t (R) with use_time]; the weights as K3's f32
//        entry takes them
//   out: gmats, gvecs (added to), demb (R,E), g_field (R,4,Sc), loss (added to)

#include "field_bwd_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

extern "C" int danerf_merged_train_f32(const float* o, const float* d, const float* emb,
                                       const float* zc, const float* fc, const float* zf,
                                       const float* target, const float* t, long long R,
                                       long long Sc, long long Sf, long long E, float* gmats,
                                       float* gvecs, float* demb, float* gfield, float* loss,
                                       const float* mats, const float* w_hi, const float* w_lo,
                                       const float* wt, const float* vecs, const long long* meta,
                                       long long n_meta, const float* wt_hi, const float* wt_lo,
                                       const long long* meta_t, long long n_meta_t,
                                       void* scratch, long long scratch_bytes, long long n_vecs,
                                       void* stream) {
  if (Sc < 1 || Sc + Sf > 256) return ERR_SHAPE;
  BwdT32Call c;
  const int err = bwd_t32_setup(meta, n_meta, mats, w_hi, w_lo, wt, vecs, E, wt_hi, wt_lo,
                                meta_t, n_meta_t, R, Sf, scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  if (merged_smem_bytes((int)Sc, (int)Sf, c.rpc) > 232448) return ERR_SHAPE;
  const f32::MergedComp32<true> comp{{target, 1.f / (float)(R * 3.0), nullptr, nullptr, nullptr,
                                      nullptr}, zc, fc, gfield, R, (int)Sc, (int)Sf};
  const Rays rays{o, d, emb, t, zf, nullptr, nullptr, R, 0, (int)Sf, c.rpc, 0};
  return run_bwd_t32(c, comp, rays, gmats, gvecs, loss, demb, (int)n_vecs,
                     static_cast<cudaStream_t>(stream));
}
