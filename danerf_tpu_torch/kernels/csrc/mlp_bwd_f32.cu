// K8 in f32 (use_bf16=False): backward of the per-sample field K1 --
// recompute the field at each tile of 128 independent rows, run the
// transposed MLP under the per-row cotangents of rgb and sigma, sum the
// parameter gradients over the rows and form demb per row, every product
// and residual in f32.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _bwd_kernel (reached via
// _fused_vjp_bwd's pallas_call) with _field_bwd_from_res at cdt = float32,
// under cfg.use_bf16 = False, and its has_time variant.  x, d (and t) get
// no gradient, as the JAX VJP returns zeros for them.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s (FFMA, no tensor core).
// The recomputed forward (531,968 MACs a row), the transposed chain
// (1,024,128) and the per-row demb (4,096) are 1,560,192 MACs a row: 6.10
// ms at the 131,072 rows of a 1024-ray fine evaluation, 3.05 ms at 65,536,
// against ~200 bytes a row of inputs and outputs.  The f32 stash (~18 KB a
// row, written and read back once, ~2.4 GB at 131,072 rows) adds ~1.4 ms
// of HBM time.
//
// Design (csrc/field_bwd_f32.cuh, K3's f32 tile with a row composite): a
// tile is 128 rows, two 64-row blocks, each loaded by load_rows and
// encoded by K1's RowEnc (y = 2^i x, the rays' form at z = 0) through
// StashEnc, which stashes the encodings and each row's own embedding for
// the appearance dW job.  The composite step is RowComp32: the caller's
// cotangents of each row.  The chain's head forms each row's demb = d_happ
// @ Wapp from the block's d_happ in shared memory (one thread an output,
// summed in c order) and writes it to demb[row].  Parameter gradients come
// from the FFMA dW pass over fixed row partitions summed in order and the
// per-block row sums summed in slot order: no atomics, so two calls on the
// same inputs give bit-identical results.  A ragged last tile is masked
// (its rows past N take zero cotangents, so they add nothing), not padded
// by the caller.  A pass holds at most MAX_TILES_PASS32 tiles (131,072
// rows).
//
//   in : x, d (N,3), emb (N,E) f32 [, t (N) with use_time]; cotangents
//        g_rgb (N,3), g_sigma (N); mats: the weights transposed (mats_kn),
//        mats_t: the weights (out, K) f32, meta_t their chain blocks'
//        offsets (as K3's f32 entry)
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (N,E)

#include "field_bwd_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

extern "C" int danerf_mlp_bwd_f32(const float* x, const float* d, const float* emb,
                                  const float* t, long long N, long long E, const float* g_rgb,
                                  const float* g_sigma, float* gmats, float* gvecs, float* demb,
                                  const void* mats, const float* vecs, const long long* meta,
                                  long long n_meta, const void* mats_t, const long long* meta_t,
                                  long long n_meta_t, void* scratch, long long scratch_bytes,
                                  long long n_vecs, void* stream) {
  Bwd32Call c;
  const int err = bwd32_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, N,
                              ROW_TILES, scratch, scratch_bytes, n_vecs, &c, true);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (N == 0) return 0;
  const RowComp32 comp{g_rgb, g_sigma};
  const Rays32 rows{x, d, emb, t, nullptr, nullptr, nullptr, N, 0, 1, c.rpc, 0};
  return run_bwd32(c, comp, rows, gmats, gvecs, nullptr, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
