// Shared code of the backward kernels (field_bwd_sm90.cuh's tile: K3, K4,
// K6, K7, K8, K9): the residual scratch's record, the composite's forward
// and transpose for one ray (the counterpart of
// danerf_tpu/kernels/fused_render.py _composite_bwd_lanes), and the dW pass
// of the narrow products (encodings, appearance projection, rgb head).
//
// Residuals.  The transposed chain needs every trunk layer's input and relu
// gate: 8 x 128 x 256 bf16 = 512 KB for a 128-row tile, where a block has
// 227 KB of shared memory.  So the tile kernel stashes the residuals in a
// scratch buffer in device memory that the wrapper allocates (Scratch
// below; ~9.5 KB a row, ~0.6 GB at a 1024-ray batch of 64 samples) and a
// second pass turns them into parameter gradients.
//
// Parameter gradients.  dW = d_pre^T @ input sums over every row of the
// batch, and CUDA blocks run in no order.  Instead of atomics (which make
// the sums differ run to run), the dW pass cuts the rows into fixed
// partitions, one block owns a tile of one dW in one partition and walks
// its rows in order, and a reduction sums the partitions in order; the
// per-tile row sums are summed in tile order.  Two runs on the same inputs
// therefore give bit-identical gradients.  The passes repeat over slices of
// at most MAX_TILES_PER_PASS tiles, each adding into the zeroed outputs, so
// the scratch stays bounded at any ray count.
//
// Numerics mirror _field_bwd_from_res: both operands of every product are
// rounded to bf16 and accumulated in f32, d_pre_rgb and the density head's
// gradients are f32, bias gradients sum the f32 d_pre.

#pragma once

#include "field.cuh"

namespace danerf {

constexpr int MAX_TILES_PER_PASS = 2048;  // 262,144 rows of residuals
constexpr int DRGB_LD = 16;               // d_pre_rgb rows, 3 used, padded for the GEMM
constexpr int DW_TILE = 64;               // dW tile edge and rows per step of pass 2
constexpr int DW_THREADS = 128;
constexpr int DW_LD = DW_TILE + 8;        // smem row stride: ldmatrix rows on distinct banks
constexpr int MAX_JOBS = 40;

// Transposed blocks of the weights (kernels/fused_mlp.py transposed_mats):
// wt_off[i] the hidden-input block of trunk layer i >= 1, wt_off[L] that of
// dir, wt_off[L + 1] the appearance projection (E x HALF, for K8's demb).
struct BwdWeights {
  const __nv_bfloat16* mats_t;
  long long wt_off[MAX_LAYERS + 2];
};

inline int parse_meta_t(const long long* m, long long n, const FieldArgs& P, const void* mats_t,
                        BwdWeights* W) {
  if (n != P.num_layers + 2) return ERR_META;
  W->mats_t = static_cast<const __nv_bfloat16*>(mats_t);
  for (int i = 0; i <= P.num_layers + 1; ++i) W->wt_off[i] = m[i];
  return 0;
}

// One pass's residuals and cotangents, rows = tiles * TILE_M, row-major.
struct Scratch {
  __nv_bfloat16* h;      // L x rows x HID: trunk layer outputs
  __nv_bfloat16* dpre;   // L x rows x HID: bf16 d_pre of each trunk layer
  __nv_bfloat16* encx;   // rows x kx
  __nv_bfloat16* encd;   // rows x kd
  __nv_bfloat16* happ;   // rows x HALF
  __nv_bfloat16* dapp;   // rows x HALF: bf16 d_happ
  __nv_bfloat16* ddir;   // rows x HALF: bf16 d_hdir_pre
  __nv_bfloat16* drgb;   // rows x DRGB_LD: bf16 d_pre_rgb
  __nv_bfloat16* embr;   // rows x E: bf16 embedding of the row's ray
  float* part;           // 2 slots a tile x nv: row sums in the vecs layout, + loss
  float* dwpart;         // parts x dw_tiles x 64 x 64: the narrow jobs' partial dW tiles
  long long rows;
  int nv;
  int dw_tiles;
};

inline int dw_tiles_of(int n_out, int n_k) {
  return ((n_out + DW_TILE - 1) / DW_TILE) * ((n_k + DW_TILE - 1) / DW_TILE);
}

inline int rays_per_tile(long long s) { return (int)(TILE_M / s < MAX_RPC ? TILE_M / s : MAX_RPC); }

// The s_tile of the per-row kernel K8: a tile holds 128 independent rows.
constexpr long long ROW_TILES = 0;

// The backward tile's per-row and per-ray arrays.  With sizeof(Smem), the
// first designs' shared memory, this struct's size also states the shapes
// K4, K6 (merged_smem_bytes) and K9 take (half_sum belonged to those
// designs' chain head).
struct BwdSmem {
  float g_rgb[TILE_M * 3];     // per-row cotangent of the field's rgb
  float g_sig[TILE_M];         // ... and of its sigma
  float dpr[TILE_M * 3];       // d_pre_rgb
  float dsp[TILE_M];           // d_sigma_pre
  float dsum[MAX_RPC * HALF];  // per-ray sums of bf16(d_happ), for demb
  float half_sum[2][2 * HALF]; // bapp / bdir row sums of the two row halves
  float loss[MAX_RPC];         // per-ray loss terms (K4, K7, K9)
};

// The first designs' shared memory for a composite of n_comp samples: Smem |
// BwdSmem | per-warp composite scratch (alpha, T, w).
inline size_t bwd_smem_bytes(int n_comp) {
  return sizeof(Smem) + sizeof(BwdSmem) + sizeof(float) * WARPS * 3 * n_comp;
}

// ------------------------------------------------------------- composite

// Forward composite of one ray by one warp (composite_ray's arithmetic),
// keeping alpha, T and w per sample for the transpose; every lane gets
// out = {rgb_r, rgb_g, rgb_b, depth, acc}.
__device__ void composite_keep(const float* z, const float* sig, const float* rgb, int n,
                               float* al, float* tr, float* wv, float out[5]) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int s0 = min(n, lane * chunk), s1 = min(n, s0 + chunk);
  float prod = 1.f;
  for (int s = s0; s < s1; ++s) {
    const float dist = (s + 1 < n) ? z[s + 1] - z[s] : 1e-3f;
    prod *= 1.f - (1.f - expf(-sig[s] * dist)) + 1e-10f;
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
    al[s] = alpha;
    tr[s] = T;
    wv[s] = w;
    acc += w;
    wz += w * z[s];
    r0 += w * rgb[s * 3 + 0];
    r1 += w * rgb[s * 3 + 1];
    r2 += w * rgb[s * 3 + 2];
    T *= 1.f - alpha + 1e-10f;
  }
  acc = warp_sum(acc);
  out[0] = warp_sum(r0);
  out[1] = warp_sum(r1);
  out[2] = warp_sum(r2);
  out[3] = warp_sum(wz) / (acc + 1e-10f);
  out[4] = acc;
}

// Transpose of the composite for one ray by one warp, from composite_keep's
// per-sample alpha/T/w (same lane chunks):
//   g_w = g_w_in + g_rgbmap . rgb_s + g_depth (z_s - depth)/(acc+1e-10) + g_acc
//   g_alpha = g_w T - (sum_{s'>s} g_w alpha T) / (1 - alpha + 1e-10)
//   g_sigma = g_alpha (1 - alpha) dist,   g_rgb_s = w_s g_rgbmap.
// The reverse exclusive sum (the TPU kernel's triangular matmul) is a
// suffix scan over the lanes' chunk sums.  g_rgb_out / g_sig_out may alias
// rgb / the sigma input: each lane reads its own chunk before writing it.
__device__ void composite_bwd(const float* z, const float* rgb, int n, const float* al,
                              const float* tr, const float* wv, float depth, float acc,
                              float g0, float g1, float g2, float g_depth, float g_acc,
                              const float* __restrict__ g_w_in, float* g_rgb_out,
                              float* g_sig_out) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int s0 = min(n, lane * chunk), s1 = min(n, s0 + chunk);
  const float inv_acc = 1.f / (acc + 1e-10f);
  float part = 0.f;
  for (int s = s0; s < s1; ++s) {
    float gw = g0 * rgb[s * 3 + 0] + g1 * rgb[s * 3 + 1] + g2 * rgb[s * 3 + 2];
    if (g_w_in != nullptr) gw += g_w_in[s];
    gw += g_depth * (z[s] - depth) * inv_acc + g_acc;
    g_sig_out[s] = gw;
    part += gw * al[s] * tr[s];
  }
  float incl = part;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  float run = incl - part;  // sum over the samples of later lanes
  for (int s = s1 - 1; s >= s0; --s) {
    const float gw = g_sig_out[s];
    const float ga = gw * tr[s] - run / (1.f - al[s] + 1e-10f);
    run += gw * al[s] * tr[s];
    const float dist = (s + 1 < n) ? z[s + 1] - z[s] : 1e-3f;
    g_sig_out[s] = ga * (1.f - al[s]) * dist;
    g_rgb_out[s * 3 + 0] = wv[s] * g0;
    g_rgb_out[s * 3 + 1] = wv[s] * g1;
    g_rgb_out[s * 3 + 2] = wv[s] * g2;
  }
}

// ------------------------------------------------------------- narrow dW

// C[n_out_store x n_k] (row stride ldc, f32) += A^T B over `rows` rows,
// A (rows x lda) and B (rows x ldb) bf16 row-major.
struct DwJob {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  float* c;
  int lda, n_out, n_out_store, ldb, n_k, ldc, tiles_k, tile0;
};

struct DwJobs {
  DwJob job[MAX_JOBS];
  int n;
  long long rows;
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ int find_job(const DwJobs& J, int tile) {
  int ji = 0;
  while (ji + 1 < J.n && J.job[ji + 1].tile0 <= tile) ++ji;
  return ji;
}

// A DW_TILE-row slab of cols [c0, c0+64) of X (ld, width n, a multiple of
// 8) into shared memory as it lies, s[row][col]; zeros past the rows or
// columns.  16 bytes a thread.
__device__ __forceinline__ void load_slab(__nv_bfloat16 (*s)[DW_LD],
                                          const __nv_bfloat16* __restrict__ x, int ld, int n,
                                          int c0, long long r0, long long r1) {
  for (int idx = threadIdx.x; idx < DW_TILE * (DW_TILE / 8); idx += DW_THREADS) {
    const int r = idx / (DW_TILE / 8), c = (idx - r * (DW_TILE / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < r1 && c0 + c < n)
      v = *reinterpret_cast<const uint4*>(x + (r0 + r) * ld + c0 + c);
    *reinterpret_cast<uint4*>(&s[r][c]) = v;
  }
}

// One block: one 64 x 64 tile of one job over the rows of partition
// blockIdx.y of PARTS; the tile's partial sum goes to dwpart.  Each warp owns 16
// output rows (m = out) x 64 columns (n = k): A^T and B fragments come from
// the row-major slabs by ldmatrix.trans (rows are the reduction index).
template <int PARTS>
__global__ void __launch_bounds__(DW_THREADS)
dw_kernel(const DwJobs J, float* __restrict__ dwpart, int n_tiles) {
  __shared__ __align__(16) __nv_bfloat16 As[DW_TILE][DW_LD];  // [row][out]
  __shared__ __align__(16) __nv_bfloat16 Bs[DW_TILE][DW_LD];  // [row][k]
  const int tile = blockIdx.x;
  const DwJob& jb = J.job[find_job(J, tile)];
  const int local = tile - jb.tile0;
  const int out0 = (local / jb.tiles_k) * DW_TILE, k0 = (local % jb.tiles_k) * DW_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long per = (J.rows + PARTS * DW_TILE - 1) / (PARTS * DW_TILE) * DW_TILE;
  const long long r_begin = blockIdx.y * per;
  const long long r_end = r_begin + per < J.rows ? r_begin + per : J.rows;

  float acc[DW_TILE / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW_TILE / 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += DW_TILE) {
    load_slab(As, jb.a, jb.lda, jb.n_out, out0, r0, r_end);
    load_slab(Bs, jb.b, jb.ldb, jb.n_k, k0, r0, r_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DW_TILE; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, &As[kk + (lane & 7) + ((lane >> 4) & 1) * 8]
                              [warp * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int nt = 0; nt < DW_TILE / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &Bs[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                [nt * 8 + ((lane >> 4) & 1) * 8]);
        mma_bf16(acc[nt], a, b);
        mma_bf16(acc[nt + 1], a, b + 2);
      }
    }
    __syncthreads();
  }
  float* out = dwpart + ((long long)blockIdx.y * n_tiles + tile) * DW_TILE * DW_TILE;
#pragma unroll
  for (int nt = 0; nt < DW_TILE / 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = warp * 16 + gid + (q >= 2 ? 8 : 0);
      const int n = nt * 8 + 2 * tig + (q & 1);
      out[m * DW_TILE + n] = acc[nt][q];
    }
  }
}

// C += the sum of the partitions' partial tiles, in partition order.
template <int PARTS>
__global__ void dw_reduce(const DwJobs J, const float* __restrict__ dwpart, int n_tiles) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_tiles * DW_TILE * DW_TILE) return;
  const int tile = (int)(idx / (DW_TILE * DW_TILE));
  const int e = (int)(idx - (long long)tile * DW_TILE * DW_TILE);
  const DwJob& jb = J.job[find_job(J, tile)];
  const int local = tile - jb.tile0;
  const int m = (local / jb.tiles_k) * DW_TILE + e / DW_TILE;
  const int n = (local % jb.tiles_k) * DW_TILE + e % DW_TILE;
  if (m >= jb.n_out_store || n >= jb.n_k) return;
  float s = 0.f;
  for (int p = 0; p < PARTS; ++p) s += dwpart[((long long)p * n_tiles + tile) * DW_TILE * DW_TILE + e];
  jb.c[(long long)m * jb.ldc + n] += s;
}

// ------------------------------------------------------------- host

inline void add_job(DwJobs& J, int& tiles, const __nv_bfloat16* a, int lda, int n_out,
                    int n_out_store, const __nv_bfloat16* b, int ldb, int n_k, float* c, int ldc) {
  DwJob& j = J.job[J.n++];
  j.a = a; j.lda = lda; j.n_out = n_out; j.n_out_store = n_out_store;
  j.b = b; j.ldb = ldb; j.n_k = n_k; j.c = c; j.ldc = ldc;
  j.tiles_k = (n_k + DW_TILE - 1) / DW_TILE;
  j.tile0 = tiles;
  tiles += ((n_out + DW_TILE - 1) / DW_TILE) * j.tiles_k;
}

}  // namespace danerf
