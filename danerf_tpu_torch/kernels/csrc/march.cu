// K2: fused ray march -- encode + NeRF-W field + composite per tile of rays.
//
// Replaces danerf_tpu/kernels/fused_render.py _render_kernel (reached via
// _march_pallas_fwd's pallas_call), with and without its want_field output.
//
// Bound on an H100: operations.  The field costs 531,968 MACs per sample,
// so one 65,536-ray x 64-sample chunk is ~4.5 TFLOP, ~4.5 ms at 989 TFLOP/s
// bf16 dense, against ~0.11 GB of per-ray HBM traffic (~33 us at 3.35 TB/s).
// The design keeps every per-sample tensor on chip: a persistent CTA walks
// over tiles of 128 (ray, sample) rows, runs the MLP on field_sm90.cuh's
// Hopper tile (weights streamed by TMA into a shared-memory ring, wgmma,
// activations in place in shared memory), then one warp per ray composites
// with a product scan.  HBM sees only per-ray inputs and outputs (+ the (R,
// 4, S) field when asked for); the weights (~1.1 MB) stream from L2 once a
// tile.
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time]
//   out: rgb (R,3), depth (R), acc (R), w (R,S) [, field (R,4,S) = r,g,b,sigma]

#include "field_sm90.cuh"

using namespace danerf;
using namespace danerf::sm90;

__global__ void __launch_bounds__(THREADS90, 1)
march_kernel(const __grid_constant__ WeightMaps maps, const FieldArgs P, const Rays rays,
             float* __restrict__ rgb, float* __restrict__ depth, float* __restrict__ acc,
             float* __restrict__ w, float* __restrict__ field) {
  Smem90& sm = smem90();
  init_ring(sm);
  if (is_producer()) {
    produce(maps, P, rays);
    return;
  }
  consumer_regs();
  const int S = rays.s, rpc = rays.rpc, tiles = my_tiles(rays.n_tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pipe pp;
  float fa[ACC];
  for (int c = 0; c < tiles; ++c) {
    const long long ray0 = (blockIdx.x + (long long)c * gridDim.x) * rpc;
    field_tile90(P, sm, c, S, rpc, pp, fa);
    const float* zs = sm.enc[c & 1].z;
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

extern "C" int danerf_march(const float* o, const float* d, const float* emb, const float* z,
                            const float* t, long long R, long long S, long long E, float* rgb,
                            float* depth, float* acc, float* w, float* field, const void* mats,
                            const float* vecs, const long long* meta, long long n_meta,
                            void* stream) {
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, mats, vecs, E, &P);
  if (err) return err;
  if (check_time(P, t)) return ERR_SHAPE;
  if (S < 1 || S > TILE_M) return ERR_SHAPE;
  if (R == 0) return 0;
  const int rpc = (int)(TILE_M / S < MAX_RPC ? TILE_M / S : MAX_RPC);
  const long long n_tiles = (R + rpc - 1) / rpc;
  WeightMaps maps;
  unsigned grid = 0;
  const int e = launch_setup(march_kernel, P, n_tiles, &maps, &grid);
  if (e) return e;
  const Rays rays{o, d, emb, t, z, nullptr, nullptr, R, n_tiles, (int)S, rpc, 0};
  march_kernel<<<grid, THREADS90, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, P, rays, rgb, depth, acc, w, field);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a CTA takes (ptxas -v reports only static
// shared memory).
extern "C" long long danerf_tile_smem_bytes() { return (long long)danerf::sm90::SMEM_BYTES; }
