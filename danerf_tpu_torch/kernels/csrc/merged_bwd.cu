// K6: the VJP of the merged composite (K5) -- recompute the field at the
// importance depths and the rank merge, transpose the composite over
// Sc + Sf with the caller's cotangents of rgb, depth, acc and the merged
// weights, un-permute to the coarse field's cotangent and the fine rows,
// and run the fine rows' transposed MLP.
//
// Replaces danerf_tpu/kernels/fused_render.py _merged_bwd_kernel (reached
// via _hier_vjp_bwd's pallas_call), which training takes for a white
// background (and, with has_time, for use_time).
//
// Bound on an H100: operations.  The field is recomputed at Sf samples a
// ray (527,872 MACs a sample) and its transposed chain is 1,024,128 MACs a
// sample: ~3 forward units, 13.0 TFLOP per 65,536-ray chunk at Sf = 64
// (13.2 ms at 989 TFLOP/s bf16 dense), 0.21 ms for a 1024-ray batch.
// Per-ray HBM traffic is ~2.2 KB in (field_c 1 KB, g_w 0.5 KB) and ~1.2 KB
// out (g_field); the residual scratch adds ~9.5 KB a fine-sample row
// (field_bwd.cuh).
//
// Design (bwd_tiles.cuh merged_tile, shared with K4): K4's tile with the
// cotangents read from the inputs instead of formed from an MSE, and no
// loss.  The depth cotangent uses the recomputed depth and acc of the
// merged composite; g_w is in merged order, as K5 returns the weights.
// The ranks of the counting merge are kept, and the un-permute is the
// inverse gather by them (the TPU's transposed one-hot matmuls).
//
//   in : o, d (R,3), emb (R,E), z_c (R,Sc), field_c (R,4,Sc), z_f (R,Sf) f32
//        [, t (R) with use_time];
//        cotangents g_rgb (R,3), g_depth, g_acc (R), g_w (R,Sc+Sf), each
//        optional (null reads as zeros)
//   out: gmats, gvecs (added to), demb (R,E), g_field (R,4,Sc)

#include "field_bwd.cuh"
#include "bwd_scratch.cuh"
#include "bwd_tiles.cuh"

using namespace danerf;

extern "C" int danerf_merged_bwd(const float* o, const float* d, const float* emb,
                                 const float* zc, const float* fc, const float* zf,
                                 const float* t, long long R,
                                 long long Sc, long long Sf, long long E, const float* g_rgb,
                                 const float* g_depth, const float* g_acc, const float* g_w,
                                 float* gmats, float* gvecs, float* demb, float* gfield,
                                 const void* mats, const float* vecs, const long long* meta,
                                 long long n_meta, const void* mats_t, const long long* meta_t,
                                 long long n_meta_t, void* scratch, long long scratch_bytes,
                                 long long n_vecs, void* stream) {
  if (Sc < 1 || Sc + Sf > 256) return ERR_SHAPE;
  BwdCall c;
  const int err = bwd_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, Sf, scratch,
                            scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  const size_t smem = merged_smem_bytes((int)Sc, (int)Sf, c.rpc);
  const RayCot cot{nullptr, 0.f, g_rgb, g_depth, g_acc, g_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_passes(c, reinterpret_cast<const void*>(merged_tile<false>), smem, gmats, gvecs,
                    nullptr, (int)n_vecs, st, [&](int nt, long long ray_base) {
                      merged_tile<false><<<nt, THREADS, smem, st>>>(
                          c.P, c.W, c.sc, o, d, emb, zc, fc, zf, t, R, (int)Sc, (int)Sf, c.rpc,
                          ray_base, cot, demb, gfield);
                    });
}
