// The per-ray pieces of the backward kernels' composites, templates over
// where a ray's composite cotangents come from:
//   MSE = true : formed in the kernel from the MSE against the target over
//                the R rays, g_rgb = 2 (rgb - target) / (3R) and no depth,
//                acc or weights cotangent; each ray's loss term is kept and
//                the tile's sum goes to the loss slot of its row sums (K7,
//                K4, K9; the danerf_tpu kernels form the same cotangent);
//   MSE = false: read from the caller's g_rgb (R,3), g_depth, g_acc (R) and
//                g_w (R, n), n the composite's samples a ray; a null pointer
//                reads as zeros, as autograd hands no cotangent for an
//                output nothing used (K3, K6).
// field_bwd_sm90.cuh's composites (K3, K4, K6, K7) and K9 (hier_onepass.cu)
// use them; merged_smem_bytes states the shapes the merged kernels (K4, K6)
// take.

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

// The merged composite's shared memory on the first designs' tile: bwd_smem_bytes(Sa),
// then the coarse depths, the merged z / sigma / rgb and the ranks of each of
// the tile's rays.  K4 and K6 take the shapes where it is at most 232,448
// bytes, as since their first design; field_bwd_sm90.cuh keeps these arrays
// in its weight ring, where all of them fit.
inline size_t merged_smem_bytes(int Sc, int Sf, int rpc) {
  const int Sa = Sc + Sf;
  return bwd_smem_bytes(Sa) + sizeof(float) * rpc * (Sc + 5 * Sa) + sizeof(int) * rpc * Sa;
}

}  // namespace danerf
