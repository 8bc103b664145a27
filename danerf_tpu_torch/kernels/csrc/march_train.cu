// K7: coarse-only training in one pass -- the ray march, the MSE against
// the target over the batch's R rays and the whole backward in one call;
// the forward is never recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _train_kernel (reached via
// _train_pallas's pallas_call).  Its two TPU branches (the dense (TR,S)
// composite chain and the lane chain) compute one function; the identity
// and triangular matmuls of both are TPU layout work-arounds that the warp
// product scan and suffix scan replace.
//
// Bound on an H100: operations.  The field runs once at S samples a ray
// (527,872 MACs a sample) and its transposed chain is 1,024,128 MACs a
// sample: ~3 forward units, 13.0 TFLOP per 65,536-ray chunk at S = 64
// (13.2 ms at 989 TFLOP/s bf16 dense), 0.21 ms for a 1024-ray batch.
// Per-ray HBM traffic is ~0.4 KB in and 0.13 KB out; the residual scratch
// adds ~9.5 KB a sample row, written and read back once (field_bwd.cuh).
//
// Design (csrc/field_bwd_sm90.cuh, K3's tile with the MSE's cotangents):
// the persistent wgmma tile runs the forward with its residuals, one warp
// per ray composites its samples and forms the rgb cotangent
// 2 (rgb - target) / (3R), as K4 does (no depth, acc or weights
// cotangent, no g_field), then transposes the composite; the transposed
// chain runs through the same TMA weight ring, and the wgmma dW pass sums
// fixed row partitions in order.  The loss masks the ragged edge by
// processing only rays < R; it is summed per tile and then in tile order,
// so loss and gradients are deterministic.
//
//   in : o, d (R,3), emb (R,E), z (R,S), target (R,3) f32 [, t (R) with use_time]
//   out: gmats, gvecs (added to), demb (R,E), loss (added to)

#include "field_bwd_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

extern "C" int danerf_march_train(const float* o, const float* d, const float* emb,
                                  const float* z, const float* target, const float* t,
                                  long long R, long long S,
                                  long long E, float* gmats, float* gvecs, float* demb,
                                  float* loss, const void* mats, const float* vecs,
                                  const long long* meta, long long n_meta, const void* mats_t,
                                  const long long* meta_t, long long n_meta_t, void* scratch,
                                  long long scratch_bytes, long long n_vecs, void* stream) {
  Bwd90Call c;
  const int err = bwd90_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, S,
                              scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  const MarchComp<true> comp{{target, 1.f / (float)(R * 3.0), nullptr, nullptr, nullptr, nullptr},
                             nullptr, (int)S};
  const BwdRays rays{o, d, emb, t, z, R, 0, 0, (int)S, c.rpc};
  return run_bwd90(c, comp, rays, gmats, gvecs, loss, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
