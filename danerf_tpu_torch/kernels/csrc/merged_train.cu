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
// Design (csrc/field_bwd_sm90.cuh, K3's tile with this composite): the
// merge is K5's per-ray counting (rank_c = i + #{z_f < z_c[i]}, rank_f = j +
// #{z_c <= z_f[j]}, coarse first on ties), and the ranks are kept so that
// the un-permute is the inverse gather by them (the TPU's transposed
// one-hot matmuls are not carried over): coarse ranks give g_field
// (R,4,Sc), fine ranks the per-row cotangents of the fine field.  The merge
// arrays live in the weight ring between the forward and the transposed
// chain.  The loss masks the ragged edge by processing only rays < R; it is
// summed per tile and then in tile order.  The shapes K4 takes are those
// whose merge arrays fit beside field.cuh's tile in 232,448 bytes
// (bwd_tiles.cuh merged_smem_bytes), as since K4's first design; all of
// them fit in the ring.
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf),
//        target (R,3) f32 [, t (R) with use_time]
//   out: gmats, gvecs (added to), demb (R,E), g_field (R,4,Sc), loss (added to)

#include "field_bwd_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

extern "C" int danerf_merged_train(const float* o, const float* d, const float* emb,
                                   const float* zc, const float* fc, const float* zf,
                                   const float* target, const float* t, long long R, long long Sc,
                                   long long Sf,
                                   long long E, float* gmats, float* gvecs, float* demb,
                                   float* gfield, float* loss, const void* mats,
                                   const float* vecs, const long long* meta, long long n_meta,
                                   const void* mats_t, const long long* meta_t,
                                   long long n_meta_t, void* scratch, long long scratch_bytes,
                                   long long n_vecs, void* stream) {
  if (Sc < 1 || Sc + Sf > 256) return ERR_SHAPE;
  Bwd90Call c;
  const int err = bwd90_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, Sf,
                              scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  if (merged_smem_bytes((int)Sc, (int)Sf, c.rpc) > 232448) return ERR_SHAPE;
  const MergedComp comp{{target, 1.f / (float)(R * 3.0), nullptr, nullptr, nullptr, nullptr},
                        zc, fc, gfield, R, (int)Sc, (int)Sf};
  const BwdRays rays{o, d, emb, t, zf, R, 0, 0, (int)Sf, c.rpc};
  return run_bwd90(c, comp, rays, gmats, gvecs, loss, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
