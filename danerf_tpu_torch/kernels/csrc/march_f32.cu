// K2 in f32 (use_bf16=False): fused ray march -- encode + NeRF-W field +
// composite per tile of rays, the field's products by 3xTF32 on the tensor
// cores.
//
// Replaces danerf_tpu/kernels/fused_render.py _render_kernel (reached via
// _march_pallas_fwd's pallas_call) under cfg.use_bf16 = False, with and
// without its want_field output, and its has_time variant.
//
// Bound on an H100: operations: 527,872 MACs a sample, three TF32
// products each, 26.9 ms a 65,536-ray x 64-sample chunk at TF32's 494.7
// TFLOP/s, against ~0.11 GB of per-ray HBM traffic (~33 us); the weights'
// hi and lo stream from L2 once a 128-row tile, ~138 GB a chunk.  The tile
// is field_f32_sm90.cuh's (persistent CTAs, a TMA ring of split weights,
// wgmma .tf32); HBM sees only the per-ray inputs and outputs (+ the (R, 4,
// S) field when asked for).
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time];
//        the packed weights in f32 and split (hi, lo: PackedParams.mats_tf32)
//   out: rgb (R,3), depth (R), acc (R), w (R,S) [, field (R,4,S) = r,g,b,sigma]

#include "field_f32_sm90.cuh"

using namespace danerf;
using namespace danerf::tf32;

__global__ void __launch_bounds__(THREADS, 1)
march_f32_kernel(const __grid_constant__ SplitMaps maps, const FieldArgs P,
                 const float* __restrict__ W, const Rays rays, float* __restrict__ rgb,
                 float* __restrict__ depth, float* __restrict__ acc, float* __restrict__ w,
                 float* __restrict__ field) {
  Smem32& sm = smem32();
  init32(sm);
  if (threadIdx.x >= CONSUMERS) {
    produce(maps, P, W, rays);
    return;
  }
  consumer_regs();
  const int S = rays.s, rpc = rays.rpc;
  const int tiles = my_tiles(rays.n_tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pipe pp;
  float fa[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long ray0 = (blockIdx.x + (long long)c * gridDim.x) * rpc;
    field_tile(P, W, sm, c, S, rpc, pp, fa);
    const float* zs = sm.tr[c & 1].z;
    for (int j = warp; j < rpc; j += CONSUMERS / 32) {
      const long long r = ray0 + j;
      if (r >= rays.R) break;
      composite_ray(zs + j * S, sm.sigma + j * S, sm.rgb + j * S * 3, S, w + r * S, rgb + r * 3,
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
    end_tile(sm, c);
  }
}

extern "C" int danerf_march_f32(const float* o, const float* d, const float* emb, const float* z,
                                const float* t, long long R, long long S, long long E,
                                float* rgb, float* depth, float* acc, float* w, float* field,
                                const float* mats, const float* w_hi, const float* w_lo,
                                const float* vecs, const long long* meta, long long n_meta,
                                void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, vecs, E, &P);
  if (err) return err;
  if (check_time(P, t)) return ERR_SHAPE;
  if (S < 1 || S > TILE_M) return ERR_SHAPE;
  if (R == 0) return 0;
  const int rpc = (int)(TILE_M / S < MAX_RPC ? TILE_M / S : MAX_RPC);
  const long long n_tiles = (R + rpc - 1) / rpc;
  SplitMaps maps;
  unsigned grid = 0;
  const int e = launch_setup(march_f32_kernel, P, w_hi, w_lo, n_tiles, &maps, &grid);
  if (e) return e;
  const Rays rays{o, d, emb, t, z, nullptr, nullptr, R, n_tiles, (int)S, rpc, 0};
  march_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, P, mats, rays, rgb, depth, acc, w, field);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a CTA takes (ptxas -v reports only static
// shared memory).
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::tf32::SMEM_BYTES; }
