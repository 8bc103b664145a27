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
// Design (field_bwd.cuh): residuals that do not fit in shared memory go to a
// scratch buffer in device memory; parameter gradients are reduced by a
// separate GEMM pass over fixed row partitions summed in order, so results
// are deterministic run to run.  The composite transpose runs one warp per
// ray with a suffix scan.
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32; cotangents g_rgb (R,3),
//        g_depth, g_acc (R), g_w (R,S) [, g_field (R,4,S)]
//   out: gmats, gvecs (packed-layout f32 gradients, added to), demb (R,E)

#include "field_bwd.cuh"

using namespace danerf;

__global__ void __launch_bounds__(THREADS, 1)
march_bwd_kernel(const FieldArgs P, const BwdWeights W, const Scratch sc,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ emb, const float* __restrict__ z, long long R, int S,
                 int rpc, long long ray_base, const float* __restrict__ g_rgb,
                 const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                 const float* __restrict__ g_w, const float* __restrict__ g_field,
                 float* __restrict__ demb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(smem_raw + sizeof(Smem));
  float* cscr = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + sizeof(BwdSmem));
  const int tile = blockIdx.x;
  const long long ray0 = ray_base + (long long)tile * rpc;
  const int nvalid = (int)(R - ray0 < rpc ? R - ray0 : rpc);

  load_rays(sm, o, d, emb, P.emb_dim, ray0, rpc, R);
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / S;
    const long long r = ray0 + j;
    sm.z[row] = (j < rpc && r < R) ? z[r * S + (row - j * S)] : 0.f;
    bs.g_sig[row] = 0.f;
    bs.g_rgb[row * 3 + 0] = 0.f; bs.g_rgb[row * 3 + 1] = 0.f; bs.g_rgb[row * 3 + 2] = 0.f;
  }
  __syncthreads();
  encode_tile(P, sm, S, rpc);
  __syncthreads();
  const Stash st{sc.h, sc.encx, sc.encd, sc.happ, sc.dirg, sc.rows * HID,
                 (long long)tile * TILE_M};
  __nv_bfloat16* cur = field_tile(P, sm, S, rpc, &st);
  __nv_bfloat16* nxt = cur == sm.hA ? sm.hB : sm.hA;

  // composite forward + transpose, one warp per ray
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nvalid; j += WARPS) {
    const long long r = ray0 + j;
    float* al = cscr + warp * 3 * S;
    float out[5];
    composite_keep(sm.z + j * S, sm.sigma + j * S, sm.rgb + j * S * 3, S, al, al + S,
                   al + 2 * S, out);
    composite_bwd(sm.z + j * S, sm.rgb + j * S * 3, S, al, al + S, al + 2 * S, out[3], out[4],
                  g_rgb[r * 3 + 0], g_rgb[r * 3 + 1], g_rgb[r * 3 + 2], g_depth[r], g_acc[r],
                  g_w + r * S, bs.g_rgb + j * S * 3, bs.g_sig + j * S);
    if (g_field != nullptr) {
      __syncwarp();
      const float* gf = g_field + r * 4 * S;
      for (int s = lane; s < S; s += 32) {
        const int row = j * S + s;
        bs.g_rgb[row * 3 + 0] += gf[s];
        bs.g_rgb[row * 3 + 1] += gf[S + s];
        bs.g_rgb[row * 3 + 2] += gf[2 * S + s];
        bs.g_sig[row] += gf[3 * S + s];
      }
    }
  }
  __syncthreads();
  field_bwd_tile(P, W, sm, bs, sc, tile, S, rpc, nvalid, cur, nxt, demb + ray0 * P.emb_dim);
}

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_passes(c, reinterpret_cast<const void*>(march_bwd_kernel), smem, gmats, gvecs,
                    nullptr, (int)n_vecs, st, [&](int nt, long long ray_base) {
                      march_bwd_kernel<<<nt, THREADS, smem, st>>>(
                          c.P, c.W, c.sc, o, d, emb, z, R, (int)S, c.rpc, ray_base, g_rgb,
                          g_depth, g_acc, g_w, g_field, demb);
                    });
}
