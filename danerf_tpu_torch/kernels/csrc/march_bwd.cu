// K3: backward of the fused ray march -- recompute the field, transpose the
// composite, add the field's own cotangent, run the transposed MLP.
//
// Replaces danerf_tpu/kernels/fused_render.py _march_bwd_kernel (reached via
// _march_bwd_call's pallas_call), with and without want_field's g_field.
//
// Bound on an H100: operations.  The forward is recomputed (527,872 MACs a
// sample, 4,096 a ray) and the transposed chain after it is 1,024,128 MACs a
// sample (dW once, d_in once, less the first layer's d_in): ~3 forward
// units, 13.0 TFLOP per 65,536-ray x 64-sample chunk, 13.2 ms at 989 TFLOP/s
// bf16 dense, 0.21 ms for a 1024-ray training batch.  Per-ray HBM traffic
// is ~1.7 KB in and 0.13 KB out; the residual scratch (~9.5 KB a row,
// written and read back once) adds ~0.6 GB at 1024 x 64, ~0.19 ms at 3.35
// TB/s.
//
// Design (csrc/field_bwd_sm90.cuh): field_sm90.cuh's Hopper tile runs the
// forward and stashes its residuals (TMA stores of each trunk layer's
// output, relu gates kept as per-thread bit masks), one warp per ray
// transposes the composite with a suffix scan, and the transposed chain
// runs on wgmma through the same TMA weight ring; the dW pass is a wgmma
// GEMM over fixed row partitions summed in order, so results are
// deterministic run to run.
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time];
//        cotangents g_rgb (R,3), g_depth, g_acc (R), g_w (R,S)
//        [, g_field (R,4,S)]; a null cotangent reads as zeros
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (R,E)

#include "field_bwd_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

extern "C" int danerf_march_bwd(const float* o, const float* d, const float* emb, const float* z,
                                const float* t, long long R, long long S, long long E,
                                const float* g_rgb, const float* g_depth, const float* g_acc,
                                const float* g_w, const float* g_field, float* gmats,
                                float* gvecs, float* demb, const void* mats, const float* vecs, const long long* meta,
                                long long n_meta, const void* mats_t, const long long* meta_t,
                                long long n_meta_t, void* scratch, long long scratch_bytes,
                                long long n_vecs, void* stream) {
  Bwd90Call c;
  const int err = bwd90_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, S,
                              scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  const MarchComp<false> comp{{nullptr, 0.f, g_rgb, g_depth, g_acc, g_w}, g_field, (int)S};
  const BwdRays rays{o, d, emb, t, z, R, 0, 0, (int)S, c.rpc};
  return run_bwd90(c, comp, rays, gmats, gvecs, nullptr, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
