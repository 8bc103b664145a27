// K8 in f32 (use_bf16=False): backward of the per-sample field K1 --
// recompute the field at each tile of 128 independent rows, run the
// transposed MLP under the per-row cotangents of rgb and sigma, sum the
// parameter gradients over the rows and form demb per row, every trunk,
// dir-layer, transposed-chain and dW product by 3xTF32 on the tensor cores.
//
// Replaces danerf_tpu/kernels/fused_mlp.py _bwd_kernel (reached via
// _fused_vjp_bwd's pallas_call) with _field_bwd_from_res at cdt = float32,
// under cfg.use_bf16 = False, and its has_time variant.  x, d (and t) get
// no gradient, as the JAX VJP returns zeros for them.
//
// Bound on an H100: operations.  The recomputed forward (531,968 MACs a
// row), the transposed chain (1,024,128) and the per-row demb (4,096) are
// 1,560,192 MACs a row; with the trunk and dir-layer products, their
// transposes and their dW three TF32 products each, 2.46 ms at the 131,072
// rows of a 1024-ray fine evaluation at TF32's 494.7 TFLOP/s, 1.23 ms at
// 65,536 (6.10 and 3.05 ms at FP32's 67).  The gate pass adds the forward
// once more on the CUDA cores (~1.0 ms at 65,536 rows at FP32's 67).
// Inputs and outputs are ~200 bytes a row; the stash (~26 KB a row,
// written and read back once) adds ~3.4 GB at 131,072 rows, ~1.0 ms at
// 3.35 TB/s.
//
// Design (csrc/field_bwd_f32_sm90.cuh, K3's f32 tile on row tiles,
// ROW_TILE): a gate pass forms the relu gates by an f32 forward on the CUDA
// cores (field_f32.cuh's field_block on each tile's two 64-row blocks,
// loaded by load_rows and encoded by RowEnc at z = 0), then the tile kernel's
// forward (field_f32_sm90.cuh field_tile<ROW_TILE>: each row's point,
// direction and time in the rays' buffers, encoded in the consumers at z =
// 0, y = 2^i x, and its appearance term an f32 FMA chain a row in the dir
// layer's epilogue) runs on those gates and stashes its residuals and each
// row's embedding; the composite step is RowComp32 (the caller's cotangents
// of each row); the chain's head forms each row's demb = d_happ @ Wapp in
// f32, summed over c in order, and writes it to demb[row]; the transposed
// chain streams W^T's TF32 halves through the weight ring; the dW pass
// (wgmma over fixed 1,024-row partitions summed in order) and the row sums
// (SLOTS a tile, summed in order) give the parameter gradients: no atomics,
// so two calls on the same inputs give bit-identical results.  A ragged last
// tile is masked (its rows past N encode as zeros and take zero
// cotangents), not padded by the caller.  A pass holds at most
// MAX_TILES_PASS32 tiles (131,072 rows).
//
//   in : x, d (N,3), emb (N,E; 16-byte aligned) f32 [, t (N) with
//        use_time]; cotangents g_rgb (N,3), g_sigma (N); the weights as
//        K3's f32 entry takes them
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (N,E)

#include "field_bwd_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

extern "C" int danerf_mlp_bwd_f32(const float* x, const float* d, const float* emb,
                                  const float* t, long long N, long long E, const float* g_rgb,
                                  const float* g_sigma, float* gmats, float* gvecs, float* demb,
                                  const float* mats, const float* w_hi, const float* w_lo,
                                  const float* wt, const float* vecs, const long long* meta,
                                  long long n_meta, const float* wt_hi, const float* wt_lo,
                                  const long long* meta_t, long long n_meta_t, void* scratch,
                                  long long scratch_bytes, long long n_vecs, void* stream) {
  BwdT32Call c;
  const int err = bwd_t32_setup(meta, n_meta, mats, w_hi, w_lo, wt, vecs, E, wt_hi, wt_lo,
                                meta_t, n_meta_t, N, ROW_TILES, scratch, scratch_bytes, n_vecs,
                                &c, true);
  if (err) return err;
  if (check_time(c.P, t)) return ERR_SHAPE;
  if (reinterpret_cast<uintptr_t>(emb) % 16) return ERR_SHAPE;  // row_app4's 16-byte loads
  if (N == 0) return 0;
  const f32::RowComp32 comp{g_rgb, g_sigma};
  const Rays rows{x, d, emb, t, nullptr, nullptr, nullptr, N, 0, 1, c.rpc, 0};
  return run_bwd_t32(c, comp, rows, gmats, gvecs, nullptr, demb, (int)n_vecs,
                     static_cast<cudaStream_t>(stream));
}
