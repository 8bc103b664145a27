// K2: fused ray march -- encode + NeRF-W field + composite per tile of rays.
//
// Replaces danerf_tpu/kernels/fused_render.py _render_kernel (reached via
// _march_pallas_fwd's pallas_call), with and without its want_field output.
//
// Bound on an H100: operations.  The field costs 531,968 MACs per sample,
// so one 65,536-ray x 64-sample chunk is ~4.5 TFLOP, ~4.5 ms at 989 TFLOP/s
// bf16 dense, against ~0.11 GB of per-ray HBM traffic (~33 us at 3.35 TB/s).
// The design therefore keeps every per-sample tensor on chip: a CTA owns 128
// (ray, sample) rows, runs the MLP on the tensor cores (bf16 mma.sync, f32
// accumulation, activations in shared memory, see field.cuh), then one warp
// per ray composites with a product scan.  HBM sees only per-ray inputs and
// outputs (+ the (R, 4, S) field when asked for).
//
//   in : o, d (R,3), emb (R,E), z (R,S) f32 [, t (R) with use_time]
//   out: rgb (R,3), depth (R), acc (R), w (R,S) [, field (R,4,S) = r,g,b,sigma]

#include "field.cuh"

using namespace danerf;

__global__ void __launch_bounds__(THREADS, 1)
march_kernel(const FieldArgs P, const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ emb, const float* __restrict__ z,
             const float* __restrict__ t, long long R, int S,
             int rpc, float* __restrict__ rgb, float* __restrict__ depth,
             float* __restrict__ acc, float* __restrict__ w, float* __restrict__ field) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const long long ray0 = (long long)blockIdx.x * rpc;

  load_rays(sm, o, d, emb, t, P.emb_dim, ray0, rpc, R);
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / S;
    const long long r = ray0 + j;
    sm.z[row] = (j < rpc && r < R) ? z[r * S + (row - j * S)] : 0.f;
  }
  __syncthreads();
  encode_tile(P, sm, S, rpc);
  __syncthreads();
  field_tile(P, sm, S, rpc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < rpc; j += WARPS) {
    const long long r = ray0 + j;
    if (r >= R) break;
    composite_ray(sm.z + j * S, sm.sigma + j * S, sm.rgb + j * S * 3, S, w + r * S,
                  rgb + r * 3, depth + r, acc + r);
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
  const size_t smem = sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (R + rpc - 1) / rpc;
  march_kernel<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      P, o, d, emb, z, t, R, (int)S, rpc, rgb, depth, acc, w, field);
  return (int)cudaGetLastError();
}
