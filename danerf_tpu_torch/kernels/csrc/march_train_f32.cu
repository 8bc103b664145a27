// K7 in f32 (use_bf16=False): coarse-only training in one pass -- the ray
// march, the MSE against the target over the batch's R rays and the whole
// backward in one call, every product by 3xTF32 on the tensor cores; the
// forward is never recomputed.
//
// Replaces danerf_tpu/kernels/fused_render.py _train_kernel (reached via
// _train_pallas's pallas_call) under cfg.use_bf16 = False, and its has_time
// variant.
//
// Bound on an H100: operations.  The field runs once at S samples a ray
// (527,872 MACs a sample) and its transposed chain is 1,024,128 MACs a
// sample: 1,552,000 a sample, three TF32 products each, 1.23 ms for a
// 1024-ray batch at S = 64 at TF32's 494.7 TFLOP/s (3.04 ms at FP32's 67),
// 9.87 ms at 8,192 rays; the gate pass adds the forward once more on the
// CUDA cores (527,872 FFMA a sample: 1.03 ms at FP32's 67).  Per-ray HBM
// traffic is ~0.4 KB in and 0.13 KB out; the stash (~26 KB a row, written
// and read back once) adds ~1.7 GB at 1024 x 64, ~0.5 ms at 3.35 TB/s.
//
// Design (csrc/field_bwd_f32_sm90.cuh, K3's f32 tile with the MSE's
// cotangents): a gate pass forms the relu gates by an f32 forward on the
// CUDA cores, field_f32_sm90.cuh's tile runs the forward on those gates and
// stashes its residuals, one warp per ray composites its samples in the
// weight ring and forms the rgb cotangent 2 (rgb - target) / (3R) (no
// depth, acc or weights cotangent, no g_field), then transposes the
// composite; the transposed chain streams W^T's TF32 halves through the
// same ring, and the dW pass sums fixed row partitions in order.  The loss
// is summed per tile, then in tile order, then pass by pass, so loss and
// gradients are deterministic.
//
//   in : o, d (R,3), emb (R,E), z (R,S), target (R,3) f32 [, t (R) with
//        use_time]; the weights as K3's f32 entry takes them
//   out: gmats, gvecs (added to), demb (R,E), loss (added to)

#include "field_bwd_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

extern "C" int danerf_march_train_f32(const float* o, const float* d, const float* emb,
                                      const float* z, const float* target, const float* t,
                                      long long R, long long S, long long E, float* gmats,
                                      float* gvecs, float* demb, float* loss, const float* mats,
                                      const float* w_hi, const float* w_lo, const float* wt,
                                      const float* vecs, const long long* meta, long long n_meta,
                                      const float* wt_hi, const float* wt_lo,
                                      const long long* meta_t, long long n_meta_t,
                                      void* scratch, long long scratch_bytes, long long n_vecs,
                                      void* stream) {
  BwdT32Call c;
  const int err = bwd_t32_setup(meta, n_meta, mats, w_hi, w_lo, wt, vecs, E, wt_hi, wt_lo,
                                meta_t, n_meta_t, R, S, scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  const f32::MarchComp32<true> comp{{target, 1.f / (float)(R * 3.0), nullptr, nullptr, nullptr,
                                     nullptr}, nullptr, (int)S};
  const Rays rays{o, d, emb, t, z, nullptr, nullptr, R, 0, (int)S, c.rpc, 0};
  return run_bwd_t32(c, comp, rays, gmats, gvecs, loss, demb, (int)n_vecs,
                     static_cast<cudaStream_t>(stream));
}
