// K3 in f32 (use_bf16=False): backward of the fused ray march -- recompute
// the field, transpose the composite, add the field's own cotangent, run
// the transposed MLP, every product by 3xTF32 on the tensor cores.
//
// Replaces danerf_tpu/kernels/fused_render.py _march_bwd_kernel (reached via
// _march_bwd_call's pallas_call) under cfg.use_bf16 = False, with and
// without want_field's g_field and its has_time variant.
//
// Bound on an H100: operations.  The forward is recomputed (527,872 MACs a
// sample, 4,096 a ray) and the transposed chain after it is 1,024,128 MACs
// a sample: 1,552,000 a sample, three TF32 products each, 1.23 ms for a
// 1024-ray training batch of 64 samples at TF32's 494.7 TFLOP/s (3.04 ms at
// FP32's 67), 9.87 ms at 8,192 rays.  The gate pass adds the forward once
// more on the CUDA cores (527,872 FFMA a sample: 1.03 ms at FP32's 67).
// Per-ray HBM traffic is ~1.7 KB in and 0.13 KB out; the stash (~26 KB a
// row, written and read back once) adds ~1.7 GB at 1024 x 64, ~0.5 ms at
// 3.35 TB/s.
//
// Design (csrc/field_bwd_f32_sm90.cuh): a gate pass forms the relu gates by
// an f32 forward on the CUDA cores, field_f32_sm90.cuh's tile runs the
// forward (the f32 K2's products) on those gates and stashes its
// residuals, one warp per ray transposes the composite in the weight ring,
// the transposed chain streams W^T's TF32 halves through the same ring,
// and the dW pass (wgmma, fixed row partitions summed in order) reads the
// stash, so results are deterministic run to run.
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time];
//        cotangents g_rgb (R,3), g_depth, g_acc (R), g_w (R,S)
//        [, g_field (R,4,S)]; a null cotangent reads as zeros;
//        mats: the packed f32 weights, w_hi / w_lo their TF32 halves
//        (PackedParams.mats_tf32), wt the weights transposed (mats_kn),
//        wt_hi / wt_lo its TF32 halves (mats_kn_tf32), meta_t the chain
//        blocks' offsets
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (R,E)

#include "field_bwd_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

extern "C" int danerf_march_bwd_f32(const float* o, const float* d, const float* emb,
                                    const float* z, const float* t, long long R, long long S,
                                    long long E, const float* g_rgb, const float* g_depth,
                                    const float* g_acc, const float* g_w, const float* g_field,
                                    float* gmats, float* gvecs, float* demb, const float* mats,
                                    const float* w_hi, const float* w_lo, const float* wt,
                                    const float* vecs,
                                    const long long* meta, long long n_meta, const float* wt_hi,
                                    const float* wt_lo, const long long* meta_t,
                                    long long n_meta_t, void* scratch, long long scratch_bytes,
                                    long long n_vecs, void* stream) {
  BwdT32Call c;
  const int err = bwd_t32_setup(meta, n_meta, mats, w_hi, w_lo, wt, vecs, E, wt_hi, wt_lo,
                                meta_t, n_meta_t, R, S, scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (R == 0) return 0;
  const f32::MarchComp32<false> comp{{nullptr, 0.f, g_rgb, g_depth, g_acc, g_w}, g_field,
                                     (int)S};
  const Rays rays{o, d, emb, t, z, nullptr, nullptr, R, 0, (int)S, c.rpc, 0};
  return run_bwd_t32(c, comp, rays, gmats, gvecs, nullptr, demb, (int)n_vecs,
                     static_cast<cudaStream_t>(stream));
}
