// K2 in f32 (use_bf16=False): fused ray march -- encode + NeRF-W field +
// composite per tile of rays, every product in f32.
//
// Replaces danerf_tpu/kernels/fused_render.py _render_kernel (reached via
// _march_pallas_fwd's pallas_call) under cfg.use_bf16 = False, with and
// without its want_field output and its has_time variant.
//
// Bound on an H100: operations at FP32's 67 TFLOP/s: 527,872 MACs a
// sample, 66.1 ms a 65,536-ray x 64-sample chunk, against ~0.11 GB of
// per-ray HBM traffic (~33 us).  The tile is field_f32.cuh's (FFMA, the
// weights streamed through two shared-memory stages); HBM sees only the
// per-ray inputs and outputs (+ the (R, 4, S) field when asked for).
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time];
//        the weights transposed, (K, N) f32 at their packed offsets
//   out: rgb (R,3), depth (R), acc (R), w (R,S) [, field (R,4,S) = r,g,b,sigma]

#include "field_f32.cuh"

using namespace danerf;
using namespace danerf::f32;

__global__ void __launch_bounds__(THREADS)
march_f32_kernel(const FieldArgs P, const float* __restrict__ wt, const Rays32 rays,
                 float* __restrict__ rgb, float* __restrict__ depth, float* __restrict__ acc,
                 float* __restrict__ w, float* __restrict__ field) {
  Smem& sm = smem_f32();
  const int S = rays.s, rpc = rays.rpc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long tile = blockIdx.x; tile < rays.n_tiles; tile += gridDim.x) {
    const long long ray0 = tile * rpc;
    const int n_rays = (int)(rays.R - ray0 < rpc ? rays.R - ray0 : rpc);
    __syncthreads();  // every warp is done with the last tile's rows
    load_rays(sm, rays, ray0, n_rays);
    field_rays(P, wt, sm, rays, ray0, n_rays);
    for (int j = warp; j < n_rays; j += THREADS / 32) {
      const long long r = ray0 + j;
      composite_ray(sm.z + j * S, sm.sigma + j * S, sm.rgb + j * S * 3, S, w + r * S, rgb + r * 3,
                    depth + r, acc + r);
      if (field != nullptr) {
        float* f = field + r * 4 * S;
        for (int s = lane; s < S; s += 32) {
          const int row = j * S + s;
          f[s] = sm.rgb[row * 3 + 0];
          f[S + s] = sm.rgb[row * 3 + 1];
          f[2 * S + s] = sm.rgb[row * 3 + 2];
          f[3 * S + s] = sm.sigma[row];
        }
      }
    }
  }
}

extern "C" int danerf_march_f32(const float* o, const float* d, const float* emb, const float* z,
                                const float* t, long long R, long long S, long long E,
                                float* rgb, float* depth, float* acc, float* w, float* field,
                                const float* wt, const float* vecs, const long long* meta,
                                long long n_meta, void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, vecs, E, &P);
  if (err) return err;
  if (check_time(P, t)) return ERR_SHAPE;
  if (S < 1 || S > TILE_M) return ERR_SHAPE;
  if (R == 0) return 0;
  const int rpc = (int)(TILE_M / S < MAX_RPC ? TILE_M / S : MAX_RPC);
  const long long n_tiles = (R + rpc - 1) / rpc;
  unsigned grid = 0;
  const int e = launch_setup(march_f32_kernel, n_tiles, &grid);
  if (e) return e;
  const Rays32 rays{o, d, emb, t, z, nullptr, nullptr, R, n_tiles, (int)S, rpc, 0};
  march_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      P, wt, rays, rgb, depth, acc, w, field);
  return (int)cudaGetLastError();
}
