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
// Design (field_bwd.cuh's mma.sync tile).  The tile kernel recomputes the forward
// with field_tile<true> (per-row staging, emb @ Wapp^T on the tensor
// cores), stashes the residuals, and walks the chain back; demb =
// bf16(d_happ) @ Wapp is one more tensor-core product per row.  Parameter
// gradients come from the dW GEMM pass over fixed row partitions summed in
// order and the per-tile row sums summed in tile order: no atomics, so two
// calls on the same inputs give bit-identical gradients.  The passes repeat
// over slices of at most MAX_TILES_PER_PASS tiles (262,144 rows).
//
//   in : x, d (N,3), emb (N,E) f32 [, t (N) with use_time]; cotangents g_rgb (N,3),
//        g_sigma (N)
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (N,E)

#include "field_bwd.cuh"
#include "bwd_scratch.cuh"

using namespace danerf;

__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_tile(const FieldArgs P, const BwdWeights W, const Scratch sc, const float* __restrict__ x,
             const float* __restrict__ d, const float* __restrict__ emb,
             const float* __restrict__ t, long long N,
             long long row_base, const float* __restrict__ g_rgb,
             const float* __restrict__ g_sigma, float* __restrict__ demb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(smem_raw + sizeof(Smem));
  RowSmem& rs = *reinterpret_cast<RowSmem*>(smem_raw + sizeof(Smem) + sizeof(BwdSmem));
  const int tile = blockIdx.x;
  const long long row0 = row_base + (long long)tile * TILE_M;
  const int nvalid = (int)(N - row0 < TILE_M ? N - row0 : TILE_M);

  load_rows(rs, x, d, emb, t, P.emb_dim, row0, nvalid);
  for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
    const bool ok = r < nvalid;
    bs.g_rgb[r * 3 + 0] = ok ? g_rgb[(row0 + r) * 3 + 0] : 0.f;
    bs.g_rgb[r * 3 + 1] = ok ? g_rgb[(row0 + r) * 3 + 1] : 0.f;
    bs.g_rgb[r * 3 + 2] = ok ? g_rgb[(row0 + r) * 3 + 2] : 0.f;
    bs.g_sig[r] = ok ? g_sigma[row0 + r] : 0.f;
  }
  __syncthreads();
  encode_rows(P, sm, rs, nvalid);
  __syncthreads();
  const Stash st{sc.h, sc.encx, sc.encd, sc.happ, sc.dirg, sc.rows * HID,
                 (long long)tile * TILE_M};
  __nv_bfloat16* cur = field_tile<true>(P, sm, 1, TILE_M, &st, rs.emb);
  __nv_bfloat16* nxt = cur == sm.hA ? sm.hB : sm.hA;
  field_bwd_tile<true>(P, W, sm, bs, sc, tile, 1, TILE_M, nvalid, cur, nxt,
                       demb + row0 * P.emb_dim, rs.emb);
}

extern "C" int danerf_mlp_bwd(const float* x, const float* d, const float* emb, const float* t,
                              long long N,
                              long long E, const float* g_rgb, const float* g_sigma,
                              float* gmats, float* gvecs, float* demb, const void* mats,
                              const float* vecs, const long long* meta, long long n_meta,
                              const void* mats_t, const long long* meta_t, long long n_meta_t,
                              void* scratch, long long scratch_bytes, long long n_vecs,
                              void* stream) {
  BwdCall c;
  const int err = bwd_setup(meta, n_meta, mats, vecs, E, mats_t, meta_t, n_meta_t, N, ROW_TILES,
                            scratch, scratch_bytes, n_vecs, &c);
  if (err) return err;
  if (c.P.emb_dim % 16 || check_time(c.P, t)) return ERR_SHAPE;   // emb @ Wapp^T steps K by 16
  if (N == 0) return 0;   // emb @ Wapp^T steps K by 16
  const size_t smem = sizeof(Smem) + sizeof(BwdSmem) + sizeof(RowSmem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_passes(c, reinterpret_cast<const void*>(mlp_bwd_tile), smem, gmats, gvecs, nullptr,
                    (int)n_vecs, st, [&](int nt, long long row_base) {
                      mlp_bwd_tile<<<nt, THREADS, smem, st>>>(c.P, c.W, c.sc, x, d, emb, t, N,
                                                              row_base, g_rgb, g_sigma, demb);
                    });
}
