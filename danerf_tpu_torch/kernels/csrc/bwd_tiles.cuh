// The tile kernels of the four backward entry points, each a template over
// where a ray's composite cotangents come from:
//   MSE = true : formed in the kernel from the MSE against the target over
//                the R rays, g_rgb = 2 (rgb - target) / (3R) and no depth,
//                acc or weights cotangent; each ray's loss term is kept and
//                the tile's sum goes to the loss slot of its row sums (K7,
//                K4; the danerf_tpu kernels form the same cotangent);
//   MSE = false: read from the caller's g_rgb (R,3), g_depth, g_acc (R) and
//                g_w (R, n), n the composite's samples a ray; a null pointer
//                reads as zeros, as autograd hands no cotangent for an
//                output nothing used (K3, K6).
// march_tile: the composite over the tile's own samples (K3 march_bwd.cu,
// K7 march_train.cu).  merged_tile: the field at the fine samples, merged
// with the coarse field by rank, and the un-permute of the cotangents to
// g_field (R,4,Sc) and the fine rows (K6 merged_bwd.cu, K4 merged_train.cu).
// Both end in field_bwd.cuh's transposed chain.  t (R) is each ray's time
// with use_time, else null.

#pragma once

#include "field_bwd.cuh"

namespace danerf {

struct RayCot {
  const float* target;   // (R,3), MSE
  float inv_denom;       // 1 / (3R), MSE
  const float* g_rgb;    // (R,3)
  const float* g_depth;  // (R)
  const float* g_acc;    // (R)
  const float* g_w;      // (R, n)
};

// The cotangents of ray r's composite outputs {rgb, depth, acc} into g and
// of its n weights into *gw (null: zero), given the composite's forward
// output out.  With MSE, lane 0 stores the ray's loss term to *loss.
template <bool MSE>
__device__ __forceinline__ void ray_cotangents(const RayCot& c, long long r, int n,
                                               const float out[5], float g[5],
                                               const float** gw, float* loss) {
  if constexpr (MSE) {
    const float d0 = out[0] - c.target[r * 3 + 0];
    const float d1 = out[1] - c.target[r * 3 + 1];
    const float d2 = out[2] - c.target[r * 3 + 2];
    if ((threadIdx.x & 31) == 0) *loss = (d0 * d0 + d1 * d1 + d2 * d2) * c.inv_denom;
    const float k2 = 2.f * c.inv_denom;
    g[0] = k2 * d0; g[1] = k2 * d1; g[2] = k2 * d2;
    g[3] = 0.f; g[4] = 0.f;
    *gw = nullptr;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = c.g_rgb != nullptr ? c.g_rgb[r * 3 + k] : 0.f;
    g[3] = c.g_depth != nullptr ? c.g_depth[r] : 0.f;
    g[4] = c.g_acc != nullptr ? c.g_acc[r] : 0.f;
    *gw = c.g_w != nullptr ? c.g_w + r * n : nullptr;
  }
}

// The tile's loss (MSE): the rays' terms summed in ray order into the slot
// after the row sums, which pass 3 sums in tile order.  After a barrier.
template <bool MSE>
__device__ __forceinline__ void store_tile_loss(const BwdSmem& bs, const Scratch& sc, int tile,
                                                int nvalid) {
  if constexpr (MSE) {
    if (threadIdx.x == 0) {
      float l = 0.f;
      for (int j = 0; j < nvalid; ++j) l += bs.loss[j];
      sc.part[(long long)tile * sc.nv + sc.nv - 1] = l;
    }
  }
}

template <bool MSE>
__global__ void __launch_bounds__(THREADS, 1)
march_tile(const FieldArgs P, const BwdWeights W, const Scratch sc, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ emb,
           const float* __restrict__ z, const float* __restrict__ t, long long R, int S, int rpc,
           long long ray_base,
           const RayCot c, const float* __restrict__ g_field, float* __restrict__ demb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(smem_raw + sizeof(Smem));
  float* cscr = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + sizeof(BwdSmem));
  const int tile = blockIdx.x;
  const long long ray0 = ray_base + (long long)tile * rpc;
  const int nvalid = (int)(R - ray0 < rpc ? R - ray0 : rpc);

  load_rays(sm, o, d, emb, t, P.emb_dim, ray0, rpc, R);
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
    float out[5], g[5];
    const float* gw;
    composite_keep(sm.z + j * S, sm.sigma + j * S, sm.rgb + j * S * 3, S, al, al + S,
                   al + 2 * S, out);
    ray_cotangents<MSE>(c, r, S, out, g, &gw, bs.loss + j);
    composite_bwd(sm.z + j * S, sm.rgb + j * S * 3, S, al, al + S, al + 2 * S, out[3], out[4],
                  g[0], g[1], g[2], g[3], g[4], gw, bs.g_rgb + j * S * 3, bs.g_sig + j * S);
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
  store_tile_loss<MSE>(bs, sc, tile, nvalid);
  field_bwd_tile(P, W, sm, bs, sc, tile, S, rpc, nvalid, cur, nxt, demb + ray0 * P.emb_dim);
}

template <bool MSE>
__global__ void __launch_bounds__(THREADS, 1)
merged_tile(const FieldArgs P, const BwdWeights W, const Scratch sc,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ emb, const float* __restrict__ zc,
            const float* __restrict__ fc, const float* __restrict__ zf,
            const float* __restrict__ t, long long R, int Sc, int Sf, int rpc,
            long long ray_base, const RayCot c, float* __restrict__ demb,
            float* __restrict__ gfield) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  BwdSmem& bs = *reinterpret_cast<BwdSmem*>(smem_raw + sizeof(Smem));
  const int Sa = Sc + Sf;
  float* cscr = reinterpret_cast<float*>(smem_raw + sizeof(Smem) + sizeof(BwdSmem));
  float* zc_s = cscr + WARPS * 3 * Sa;        // rpc x Sc
  float* mz = zc_s + rpc * Sc;                // rpc x Sa
  float* msig = mz + rpc * Sa;                // rpc x Sa
  float* mrgb = msig + rpc * Sa;              // rpc x Sa x 3
  int* rank_c = reinterpret_cast<int*>(mrgb + rpc * Sa * 3);  // rpc x Sc
  int* rank_f = rank_c + rpc * Sc;                             // rpc x Sf
  const int tile = blockIdx.x;
  const long long ray0 = ray_base + (long long)tile * rpc;
  const int nvalid = (int)(R - ray0 < rpc ? R - ray0 : rpc);

  load_rays(sm, o, d, emb, t, P.emb_dim, ray0, rpc, R);
  for (int row = threadIdx.x; row < TILE_M; row += THREADS) {
    const int j = row / Sf;
    const long long r = ray0 + j;
    sm.z[row] = (j < rpc && r < R) ? zf[r * Sf + (row - j * Sf)] : 0.f;
    bs.g_sig[row] = 0.f;
    bs.g_rgb[row * 3 + 0] = 0.f; bs.g_rgb[row * 3 + 1] = 0.f; bs.g_rgb[row * 3 + 2] = 0.f;
  }
  for (int idx = threadIdx.x; idx < rpc * Sc; idx += THREADS) {
    const long long r = ray0 + idx / Sc;
    zc_s[idx] = r < R ? zc[r * Sc + idx % Sc] : 0.f;
  }
  __syncthreads();
  encode_tile(P, sm, Sf, rpc);
  __syncthreads();
  const Stash st{sc.h, sc.encx, sc.encd, sc.happ, sc.dirg, sc.rows * HID,
                 (long long)tile * TILE_M};
  __nv_bfloat16* cur = field_tile(P, sm, Sf, rpc, &st);
  __nv_bfloat16* nxt = cur == sm.hA ? sm.hB : sm.hA;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nvalid; j += WARPS) {
    const long long r = ray0 + j;
    float* mzj = mz + j * Sa;
    float* msj = msig + j * Sa;
    float* mrj = mrgb + j * Sa * 3;
    int* rcj = rank_c + j * Sc;
    int* rfj = rank_f + j * Sf;
    merge_ray(sm, zc_s + j * Sc, Sc, sm.z + j * Sf, Sf, fc + r * 4 * Sc, j * Sf, mzj, msj, mrj,
              rcj, rfj);
    float* al = cscr + warp * 3 * Sa;
    float out[5], g[5];
    const float* gw;
    composite_keep(mzj, msj, mrj, Sa, al, al + Sa, al + 2 * Sa, out);
    ray_cotangents<MSE>(c, r, Sa, out, g, &gw, bs.loss + j);
    // the transpose overwrites the merged rgb / sigma with their cotangents
    composite_bwd(mzj, mrj, Sa, al, al + Sa, al + 2 * Sa, out[3], out[4], g[0], g[1], g[2],
                  g[3], g[4], gw, mrj, msj);
    __syncwarp();
    // un-permute: the inverse gather by the kept ranks
    float* gf = gfield + r * 4 * Sc;
    for (int i = lane; i < Sc; i += 32) {
      const int k = rcj[i];
      gf[i] = mrj[k * 3 + 0];
      gf[Sc + i] = mrj[k * 3 + 1];
      gf[2 * Sc + i] = mrj[k * 3 + 2];
      gf[3 * Sc + i] = msj[k];
    }
    for (int i = lane; i < Sf; i += 32) {
      const int k = rfj[i];
      const int row = j * Sf + i;
      bs.g_rgb[row * 3 + 0] = mrj[k * 3 + 0];
      bs.g_rgb[row * 3 + 1] = mrj[k * 3 + 1];
      bs.g_rgb[row * 3 + 2] = mrj[k * 3 + 2];
      bs.g_sig[row] = msj[k];
    }
  }
  __syncthreads();
  store_tile_loss<MSE>(bs, sc, tile, nvalid);
  field_bwd_tile(P, W, sm, bs, sc, tile, Sf, rpc, nvalid, cur, nxt, demb + ray0 * P.emb_dim);
}

// merged_tile's shared memory: bwd_smem_bytes(Sa), then the coarse depths,
// the merged z / sigma / rgb and the ranks of each of the tile's rays.
inline size_t merged_smem_bytes(int Sc, int Sf, int rpc) {
  const int Sa = Sc + Sf;
  return bwd_smem_bytes(Sa) + sizeof(float) * rpc * (Sc + 5 * Sa) + sizeof(int) * rpc * Sa;
}

}  // namespace danerf
