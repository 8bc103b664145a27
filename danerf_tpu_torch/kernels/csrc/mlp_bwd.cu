// K8: backward of the per-sample field K1 -- recompute the tile of 128
// independent rows, run the transposed MLP under the per-row cotangents of
// rgb and sigma, and sum the parameter gradients over the rows.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _bwd_kernel (reached via
// _fused_vjp_bwd's pallas_call) with _field_bwd_from_res, the VJP of
// fused_nerf_apply.  x, d (and t) get no gradient, as the JAX VJP returns
// zeros for them.
//
// Bound on an H100: operations.  The recomputed forward (531,968 MACs a
// row), the transposed chain (1,024,128: every weight once for dW, the
// hidden part of each d_in but the first layer's) and the per-row demb
// (4,096) are 1,560,192 MACs a row: 0.41 TFLOP, 0.41 ms at 989 TFLOP/s bf16
// dense, at the 131,072 rows of a 1024-ray fine pass, against ~200 bytes a
// row of inputs and outputs.  The residual scratch (~9.5 KB a row, written
// and read back once, ~1.25 GB at 131,072 rows) adds ~0.75 ms of HBM time.
//
// Design: field_bwd_sm90.cuh's persistent tile (a TMA weight ring, wgmma for
// the forward and the transposed chain, the wgmma dW pass) with one row a
// "ray" (RowComp: the caller's cotangents of each row).  What a tile of
// independent rows needs beyond the rays' tile: the encoders read each
// row's point, direction and time from device memory (y = 2^i x, the
// rays' form at z = 0) and stash the rows' bf16 embeddings before they
// publish the buffer; the producer then loads Wapp and those embeddings
// into one ring stage, and emb @ Wapp^T is one more wgmma (m64n128, K = E)
// into the accumulator registers beside the dir layer's (the two together
// take a trunk layer's m64n256), added after the dir layer's relu in f32
// (the JAX order).  In the chain's head demb = bf16(d_happ) @ Wapp per row
// is a wgmma (m64n64, K = HALF) with A = d_happ in the activation buffer and
// B = Wapp^T from one more ring stage (zero past E).  Parameter gradients
// come from the dW pass over fixed row partitions summed in order and the
// per-tile row sums summed in tile order: no atomics, so two calls on the
// same inputs give bit-identical gradients.  The passes repeat over slices
// of at most MAX_TILES_PER_PASS tiles (262,144 rows); a ragged last tile is
// masked (zero cotangents), not padded by the caller.
//
//   in : x, d (N,3), emb (N,E) f32 [, t (N) with use_time]; cotangents g_rgb (N,3),
//        g_sigma (N)
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (N,E)

#include "field_bwd_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

extern "C" int danerf_mlp_bwd(const float* x, const float* d, const float* emb, const float* t,
                              long long N,
                              long long E, const float* g_rgb, const float* g_sigma,
                              float* gmats, float* gvecs, float* demb, const void* mats,
                              const float* vecs, const long long* meta, long long n_meta,
                              const void* mats_t, const long long* meta_t, long long n_meta_t,
                              void* scratch, long long scratch_bytes, long long n_vecs,
                              void* stream) {
  Bwd90Call c;
  const int err = bwd90_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, N, ROW_TILES,
                              scratch, scratch_bytes, n_vecs, &c, true);
  if (err) return err;
  // the appearance product steps K by 16
  if (c.P.emb_dim % 16 || check_time(c.P, t)) return ERR_SHAPE;
  if (N == 0) return 0;
  const RowComp comp{g_rgb, g_sigma};
  const BwdRays rows{x, d, emb, t, nullptr, N, 0, 0, 1, ROWS, 0};
  return run_bwd90(c, comp, rows, gmats, gvecs, nullptr, demb, (int)n_vecs,
                   static_cast<cudaStream_t>(stream));
}
