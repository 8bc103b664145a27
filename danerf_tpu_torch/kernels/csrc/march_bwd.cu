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
// Design (bwd_tiles.cuh march_tile, shared with K7; field_bwd.cuh):
// residuals that do not fit in shared memory go to a scratch buffer in
// device memory; parameter gradients are reduced by a separate GEMM pass
// over fixed row partitions summed in order, so results are deterministic
// run to run.  The composite transpose runs one warp per ray with a suffix
// scan.
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32; cotangents g_rgb (R,3),
//        g_depth, g_acc (R), g_w (R,S) [, g_field (R,4,S)]; a null
//        cotangent reads as zeros
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (R,E)

#include "field_bwd.cuh"
#include "bwd_tiles.cuh"

using namespace danerf;

extern "C" int danerf_march_bwd(const float* o, const float* d, const float* emb, const float* z,
                                long long R, long long S, long long E, const float* g_rgb,
                                const float* g_depth, const float* g_acc, const float* g_w,
                                const float* g_field, float* gmats, float* gvecs, float* demb,
                                const void* mats, const float* vecs, const long long* meta,
                                long long n_meta, const void* mats_t, const long long* meta_t,
                                long long n_meta_t, void* scratch, long long scratch_bytes,
                                long long n_vecs, void* stream) {
  BwdCall c;
  const int err = bwd_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, R, S, scratch,
                            scratch_bytes, n_vecs, &c);
  if (err || R == 0) return err;
  const size_t smem = bwd_smem_bytes((int)S);
  const RayCot cot{nullptr, 0.f, g_rgb, g_depth, g_acc, g_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_passes(c, reinterpret_cast<const void*>(march_tile<false>), smem, gmats, gvecs,
                    nullptr, (int)n_vecs, st, [&](int nt, long long ray_base) {
                      march_tile<false><<<nt, THREADS, smem, st>>>(
                          c.P, c.W, c.sc, o, d, emb, z, R, (int)S, c.rpc, ray_base, cot, g_field,
                          demb);
                    });
}
