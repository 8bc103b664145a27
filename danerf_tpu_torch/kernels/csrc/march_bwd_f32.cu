// K3 in f32 (use_bf16=False): backward of the fused ray march -- recompute
// the field, transpose the composite, add the field's own cotangent, run
// the transposed MLP, every product and residual in f32.
//
// Replaces danerf_tpu/kernels/fused_render.py _march_bwd_kernel (reached via
// _march_bwd_call's pallas_call) under cfg.use_bf16 = False, with and
// without want_field's g_field and its has_time variant.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s (FFMA, no tensor core).
// The forward is recomputed (527,872 MACs a sample, 4,096 a ray) and the
// transposed chain after it is 1,024,128 MACs a sample: 1,552,000 a sample,
// 3.04 ms for a 1024-ray training batch of 64 samples, 24.3 ms at 8,192
// rays.  Per-ray HBM traffic is ~1.7 KB in and 0.13 KB out; the f32 stash
// (~18 KB a row, written and read back once) adds ~1.2 GB at 1024 x 64,
// ~0.36 ms at 3.35 TB/s.
//
// Design (csrc/field_bwd_f32.cuh): field_f32.cuh's FFMA tile runs the
// forward and stashes its residuals in f32, one warp per ray transposes
// the composite, the transposed chain runs on the same FFMA slice with W's
// own rows as B, and the dW pass sums fixed row partitions in order, so
// results are deterministic run to run.
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time];
//        cotangents g_rgb (R,3), g_depth, g_acc (R), g_w (R,S)
//        [, g_field (R,4,S)]; a null cotangent reads as zeros;
//        mats: the weights transposed (mats_kn), mats_t: the weights (out,
//        K) f32, meta_t their chain blocks' offsets
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (R,E)

#include "field_bwd_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

extern "C" int danerf_march_bwd_f32(const float* o, const float* d, const float* emb,
                                    const float* z, const float* t, long long R, long long S,
                                    long long E, const float* g_rgb, const float* g_depth,
                                    const float* g_acc, const float* g_w, const float* g_field,
                                    float* gmats, float* gvecs, float* demb, const void* mats,
                                    const float* vecs, const long long* meta, long long n_meta,
                                    const void* mats_t, const long long* meta_t,
                                    long long n_meta_t, void* scratch, long long scratch_bytes,
                                    long long n_vecs, void* stream) {
  Bwd32Call c;
  const int err = bwd32_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, S,
                              scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  const MarchComp32<false> comp{{nullptr, 0.f, g_rgb, g_depth, g_acc, g_w}, g_field, (int)S};
  const Rays32 rays{o, d, emb, t, z, nullptr, nullptr, R, 0, (int)S, c.rpc, 0};
  return run_bwd32(c, comp, rays, gmats, gvecs, nullptr, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
