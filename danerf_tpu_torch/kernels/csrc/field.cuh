// Shared device code of every kernel: the argument record and its parsing,
// the composite of one ray, the error strings, and the shape rule of the
// merged kernels.  The field itself runs on field_sm90.cuh's Hopper tile
// (K1, K2, K5) and, with its residuals kept, on field_bwd_sm90.cuh's (K3,
// K4, K6-K9): the counterpart of danerf_tpu/kernels/fused_mlp.py _encode +
// _field_from_enc.
//
// Numerics (use_bf16): encodings and activations are held in bf16, every
// matmul accumulates in f32 on the tensor cores, the density head is an f32
// multiply-and-sum over the bf16 trunk output, and happ = relu(hdir_pre) +
// emb@Wapp + bapp is formed in f32 before the bf16 rgb matmul -- the same
// roundings as the JAX kernel, in another summation order.
//
// Time (use_time, the JAX kernels' has_time variants): the encoded time
// [t, sin(2^i t), cos(2^i t), ...] follows the encoded position in the
// position encoding's columns, so it enters the first layer and every skip
// layer with it; a null t pointer means a layout without time.  At the
// default widths that is kx = 80 instead of 64 (63 + 13 columns, padded to
// 16) and 534,528 MACs a sample instead of 527,872 (+1.3%).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace danerf {

constexpr int HID = 256;            // trunk width (kernel-supported value)
constexpr int HALF = HID / 2;       // dir-branch width
constexpr int TILE_M = 128;         // rows (samples) per CTA
constexpr int MAX_LAYERS = 16;
constexpr int MAX_RPC = 8;          // rays per CTA
constexpr int MAX_KX = 80;          // padded position (+ time) encoding width
constexpr int MAX_KD = 32;          // padded direction encoding width
constexpr int MAX_E = 64;           // appearance embedding width

struct FieldArgs {
  const __nv_bfloat16* mats;   // packed matrices, (out, K_pad) row-major
  const float* vecs;           // biases + density weight
  int num_layers, skip_mask, pos_levels, dir_levels, kx, kd, softplus, emb_dim;
  int time_levels;             // -1: no time input
  int nt;                      // time encoding width: 0, or 1 + 2 time_levels
  long long w_off[MAX_LAYERS], b_off[MAX_LAYERS];
  long long wd_off, bd_off, wdir_off, bdir_off, wapp_off, bapp_off, wrgb_off, brgb_off;
};

// The shape rule of the merged kernels.  The first designs of K4, K5, K6
// and K9 kept their merge and composite arrays beside a 177,376-byte tile
// (two 128 x 264 bf16 activation buffers, the encodings at row strides of
// 88 and 40, the rows' and rays' f32 arrays) in the 232,448 bytes a block
// may use, and the shapes that fitted are the shapes they take (merged.cu,
// bwd_tiles.cuh merged_smem_bytes, hier_onepass.cu hier_smem_bytes); their
// Hopper tiles hold every one of those shapes.  WARPS: that tile's warps,
// each with its composite's per-sample scratch.
constexpr size_t SHAPE_TILE_BYTES = 177376;
constexpr int WARPS = 8;

// Error codes below 0 are argument errors; codes >= 0 are cudaError_t.
constexpr int ERR_META = -1;      // packed layout record malformed
constexpr int ERR_SHAPE = -2;     // a width this kernel does not take

// Parse the integer layout record written by kernels/fused_mlp.py
// kernel_meta(): a head of META_HEAD values, L weight and L bias offsets, and
// the 8 offsets of the heads.
constexpr int META_HEAD = 10;
inline int parse_meta(const long long* meta, long long n_meta, const void* mats,
                      const float* vecs, long long emb_dim, FieldArgs* a) {
  if (n_meta < META_HEAD) return ERR_META;
  const int L = (int)meta[0];
  if (L < 1 || L > MAX_LAYERS || n_meta != META_HEAD + 2 * L + 8) return ERR_META;
  a->mats = static_cast<const __nv_bfloat16*>(mats);
  a->vecs = vecs;
  a->num_layers = L;
  a->skip_mask = (int)meta[1];
  a->pos_levels = (int)meta[2];
  a->dir_levels = (int)meta[3];
  a->kx = (int)meta[4];
  a->kd = (int)meta[5];
  const long long hidden = meta[6];
  a->softplus = (int)meta[7];
  a->emb_dim = (int)meta[8];
  a->time_levels = (int)meta[9];
  a->nt = a->time_levels < 0 ? 0 : 1 + 2 * a->time_levels;
  if (hidden != HID || a->emb_dim != emb_dim || a->emb_dim < 1 || a->emb_dim > MAX_E ||
      a->kx > MAX_KX || a->kd > MAX_KD || a->kx % 16 || a->kd % 16 || a->time_levels < -1 ||
      a->kx < 3 * (1 + 2 * a->pos_levels) + a->nt || a->kd < 3 * (1 + 2 * a->dir_levels))
    return ERR_SHAPE;
  for (int i = 0; i < L; ++i) {
    a->w_off[i] = meta[META_HEAD + i];
    a->b_off[i] = meta[META_HEAD + L + i];
  }
  const long long* t = meta + META_HEAD + 2 * L;
  a->wd_off = t[0]; a->bd_off = t[1]; a->wdir_off = t[2]; a->bdir_off = t[3];
  a->wapp_off = t[4]; a->bapp_off = t[5]; a->wrgb_off = t[6]; a->brgb_off = t[7];
  return 0;
}

// A time input where the layout has time columns, none where it has not.
inline int check_time(const FieldArgs& P, const float* t) {
  return (t != nullptr) == (P.nt > 0) ? 0 : ERR_SHAPE;
}

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Composite one ray with one warp: alpha = 1 - exp(-sigma * dist) (1e-3 tail
// distance), T = exclusive product of (1 - alpha + 1e-10) as a warp scan
// over per-lane chunks (the TPU kernel's triangular matmul becomes a scan),
// w = alpha T, depth = sum(w z) / (acc + 1e-10).  Writes w_out[0..n) and the
// ray's rgb/depth/acc.
__device__ void composite_ray(const float* z, const float* sig, const float* rgb, int n,
                              float* __restrict__ w_out, float* __restrict__ rgb_out,
                              float* __restrict__ depth_out, float* __restrict__ acc_out) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int s0 = min(n, lane * chunk), s1 = min(n, s0 + chunk);
  float prod = 1.f;
  for (int s = s0; s < s1; ++s) {
    const float dist = (s + 1 < n) ? z[s + 1] - z[s] : 1e-3f;
    const float alpha = 1.f - expf(-sig[s] * dist);
    prod *= 1.f - alpha + 1e-10f;
  }
  float incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl *= v;
  }
  float T = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) T = 1.f;
  float acc = 0.f, wz = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f;
  for (int s = s0; s < s1; ++s) {
    const float dist = (s + 1 < n) ? z[s + 1] - z[s] : 1e-3f;
    const float alpha = 1.f - expf(-sig[s] * dist);
    const float w = alpha * T;
    w_out[s] = w;
    acc += w;
    wz += w * z[s];
    r0 += w * rgb[s * 3 + 0];
    r1 += w * rgb[s * 3 + 1];
    r2 += w * rgb[s * 3 + 2];
    T *= 1.f - alpha + 1e-10f;
  }
  acc = warp_sum(acc); wz = warp_sum(wz);
  r0 = warp_sum(r0); r1 = warp_sum(r1); r2 = warp_sum(r2);
  if (lane == 0) {
    rgb_out[0] = r0; rgb_out[1] = r1; rgb_out[2] = r2;
    *depth_out = wz / (acc + 1e-10f);
    *acc_out = acc;
  }
}

}  // namespace danerf

extern "C" const char* danerf_error_string(int code) {
  if (code == danerf::ERR_META) return "malformed packed-parameter layout record";
  if (code == danerf::ERR_SHAPE) return "a width this kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
