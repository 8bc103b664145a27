// K7 in f32 (use_bf16=False): coarse-only training in one pass -- the ray
// march, the MSE against the target over the batch's R rays and the whole
// backward in one call, every product and residual in f32; the forward is
// never recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _train_kernel (reached via
// _train_pallas's pallas_call) under cfg.use_bf16 = False, and its has_time
// variant.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s (FFMA, no tensor core).
// The field runs once at S samples a ray (527,872 MACs a sample) and its
// transposed chain is 1,024,128 MACs a sample: 1,552,000 a sample, 3.04 ms
// for a 1024-ray batch at S = 64, 24.3 ms at 8,192 rays.  Per-ray HBM
// traffic is ~0.4 KB in and 0.13 KB out; the f32 stash adds ~18 KB a
// sample row, written and read back once.
//
// Design (csrc/field_bwd_f32.cuh, K3's f32 tile with the MSE's
// cotangents): one warp per ray composites its samples and forms the rgb
// cotangent 2 (rgb - target) / (3R) (no depth, acc or weights cotangent),
// then transposes the composite; the loss is summed per tile, then in tile
// order, so loss and gradients are deterministic.
//
//   in : o, d (R,3), emb (R,E), z (R,S), target (R,3) f32 [, t (R) with
//        use_time]; mats, mats_t, meta_t as K3's f32 entry
//   out: gmats, gvecs (added to), demb (R,E), loss (added to)

#include "field_bwd_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

extern "C" int danerf_march_train_f32(const float* o, const float* d, const float* emb,
                                      const float* z, const float* target, const float* t,
                                      long long R, long long S, long long E, float* gmats,
                                      float* gvecs, float* demb, float* loss, const void* mats,
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
  const MarchComp32<true> comp{{target, 1.f / (float)(R * 3.0), nullptr, nullptr, nullptr,
                                nullptr}, nullptr, (int)S};
  const Rays32 rays{o, d, emb, t, z, nullptr, nullptr, R, 0, (int)S, c.rpc, 0};
  return run_bwd32(c, comp, rays, gmats, gvecs, loss, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
