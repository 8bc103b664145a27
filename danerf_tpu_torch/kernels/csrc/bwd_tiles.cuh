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
// field_bwd_sm90.cuh's composites (K3, K4, K6, K7), bwd_f32_parts.cuh's and
// both K9s use them; merged_smem_bytes states the shapes the merged kernels
// (K4, K6) take.  Then what both K9s (hier_onepass.cu, hier_onepass_f32.cu)
// share: the shapes they take, the inverse CDF of a ray's coarse weights,
// their arguments beyond the rays and the sum of their two losses.

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

// ------------------------------------------------------------- K9

// The shapes K9 takes (hier_onepass.cu and its f32 variant), as since its
// first design: those whose per-ray arrays fit beside that design's tile
// (field.cuh SHAPE_TILE_BYTES) and BwdSmem in 232,448 bytes (all of them fit
// in field_bwd_sm90.cuh's tile and in field_bwd_f32_sm90.cuh's):
// the per-warp composite scratch of Sa = Sc + Sf samples, then, for each
// of the tile's rays, the coarse and fine depths, the kept coarse field,
// sigma_pre and field cotangent, the merged depths, sigma and rgb, demb and
// the ranks (4 bytes each).
inline size_t hier_smem_bytes(int Sc, int Sf, int rpc, int E) {
  const int Sa = Sc + Sf;
  return bwd_smem_bytes(Sa) +
         4 * (size_t)rpc * (Sc + Sf + 4 * Sc + Sc + 4 * Sc + Sa + Sa + 3 * Sa + E + Sc + Sf);
}

// The inverse CDF of one ray's n weights w at its m uniforms u, by one warp,
// with ops/sampling.sample_pdf's arithmetic: wn = (w + 1e-5) / sum(w + 1e-5);
// cdf = [0, inclusive prefix sum of wn] (n + 1 values into cdf; a scan over
// the lanes' chunks); the bracket of u is inds = #{cdf < u} (searchsorted,
// right=False); cdf_above is +max-float past the end, z_above clamped into
// range, and a bracket narrower than 1e-5 gets a denominator of 1.  Writes
// z_out (m), sorted when u is increasing.
__device__ void inverse_cdf(const float* z, const float* w, int n, const float* __restrict__ u,
                            int m, float* cdf, float* z_out) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int s0 = min(n, lane * chunk), s1 = min(n, s0 + chunk);
  float part = 0.f;
  for (int s = s0; s < s1; ++s) part += w[s] + 1e-5f;
  const float total = warp_sum(part);
  float run = 0.f;
  for (int s = s0; s < s1; ++s) run += (w[s] + 1e-5f) / total;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float c = incl - run;  // the sum over the samples of earlier lanes
  if (lane == 0) cdf[0] = 0.f;
  for (int s = s0; s < s1; ++s) {
    c += (w[s] + 1e-5f) / total;
    cdf[s + 1] = c;
  }
  __syncwarp();
  const float big = 3.402823466e38f;  // f32 max
  for (int i = lane; i < m; i += 32) {
    const float ui = u[i];
    int inds = 0;
    for (int k = 0; k <= n; ++k) inds += cdf[k] < ui;
    const float below = cdf[max(inds - 1, 0)];
    const float above = inds <= n ? cdf[inds] : big;
    const float zb = z[max(min(inds, n) - 1, 0)];
    const float za = z[min(inds, n - 1)];
    float denom = above - below;
    if (denom < 1e-5f) denom = 1.f;
    const float tt = (ui - below) / denom;
    z_out[i] = zb + tt * (za - zb);
  }
  __syncwarp();
}

// K9's inputs beyond the rays: the coarse depths z_c (R, Sc) (also
// rays.z), the uniforms u (R, Sf), the target (R,3), 1 / (3R) and
// cw x 2 / (3R).
struct HierArgs {
  const float* zc;
  const float* u;
  const float* target;
  float inv_denom, kc;
  int Sc, Sf;
};

// The two losses of a pass: loss[0] += the fine slots (odd virtual tiles),
// loss[1] += the coarse slots (even ones); a virtual tile's loss is the
// last column of the first of its `slots` row-sum slots
// (field_bwd_f32_sm90.cuh's SLOTS on the f32 K9's tile).  Warp k sums
// loss k, each lane every 32nd of its tiles in order, then the lanes in a
// fixed tree.
__device__ __forceinline__ void hier_losses_of(const float* __restrict__ part, int vtiles,
                                               int nv, int slots, float* __restrict__ loss) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.f;
  for (int v = 1 - k + 2 * lane; v < vtiles; v += 64)
    s += part[(long long)slots * v * nv + nv - 1];
  s = warp_sum(s);
  if (lane == 0) loss[k] += s;
}

__global__ void hier_losses(const float* __restrict__ part, int vtiles, int nv,
                            float* __restrict__ loss) {
  hier_losses_of(part, vtiles, nv, 2, loss);
}

}  // namespace danerf
