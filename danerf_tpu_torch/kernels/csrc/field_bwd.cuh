// Shared code of the backward kernels K8 (mlp_bwd.cu), whose tile holds
// 128 independent rows, and K9 (hier_onepass.cu); K3, K4, K6 and K7
// (field_bwd_sm90.cuh) take the composite's transpose and the dW pass of
// the narrow jobs from here: the composite's transpose for one ray,
// the transposed MLP chain on a tile of 128 rows (the counterpart of
// danerf_tpu/kernels/fused_mlp.py _field_bwd_from_res and
// danerf_tpu/kernels/fused_render.py _composite_bwd_lanes), and the two
// passes that turn the per-row cotangents into parameter gradients.
//
// Residuals.  The transposed chain needs every trunk layer's input and relu
// gate: 8 x 128 x 256 bf16 = 512 KB for a 128-row tile, where a block has
// 227 KB of shared memory and the forward tile already takes 174 KB.  So
// the residuals go to a scratch buffer in device memory that the wrapper
// allocates (Scratch below; ~9.5 KB a row, ~0.6 GB at a 1024-ray batch of
// 64 samples): the tile kernel (pass 1) recomputes the forward, stashes each
// layer's output, runs the composite transpose, and walks the chain back to
// the first layer -- d_in = bf16(d_pre) @ W on the tensor cores, with the
// gates read back from the stash -- storing every layer's bf16 d_pre.
// Row sums (biases, density head) are written per tile, and per-ray sums
// (demb, g_field) per ray (K8: demb per row), by the block that owns the
// rays: no atomics in device memory.
//
// Parameter gradients.  dW = d_pre^T @ input sums over every row of the
// batch, and CUDA blocks run in no order.  Instead of atomics (which make
// the sums differ run to run), pass 2 is a separate GEMM kernel: the rows
// are cut into DW_PARTS fixed partitions, one block owns a 64 x 64 tile of
// one dW in one partition and walks its rows in order, and a reduction sums
// the partitions in order; pass 3 sums the per-tile row sums in tile order.
// Two runs on the same inputs therefore give bit-identical gradients.  The
// passes repeat over slices of at most MAX_TILES_PER_PASS tiles, each adding
// into the zeroed outputs, so the scratch stays bounded at any ray count.
//
// Numerics mirror _field_bwd_from_res: both operands of every product are
// rounded to bf16 and accumulated in f32 (dotT_a, dot_wT), d_pre_rgb and the
// density head's gradients are f32, bias gradients sum the f32 d_pre.

#pragma once

#include "field.cuh"

namespace danerf {

constexpr int MAX_TILES_PER_PASS = 2048;  // 262,144 rows of residuals
constexpr int DRGB_LD = 16;               // d_pre_rgb rows, 3 used, padded for the GEMM
constexpr int DW_TILE = 64;               // dW tile edge and rows per step of pass 2
constexpr int DW_THREADS = 128;
constexpr int DW_PARTS = 8;               // row partitions of pass 2
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
  unsigned char* dirg;   // rows x HALF
  float* part;           // tiles x nv: per-tile row sums in the vecs layout, + loss
  float* dwpart;         // DW_PARTS x dw_tiles x 64 x 64: pass 2's partial dW tiles
  long long rows;
  int nv;
  int dw_tiles;
};

inline int dw_tiles_of(int n_out, int n_k) {
  return ((n_out + DW_TILE - 1) / DW_TILE) * ((n_k + DW_TILE - 1) / DW_TILE);
}

// The number of 64 x 64 dW tiles pass 2 computes (finish_pass's jobs).
inline int count_dw_tiles(const FieldArgs& P) {
  int n = 0;
  for (int i = 0; i < P.num_layers; ++i) {
    if (i == 0) n += dw_tiles_of(HID, P.kx);
    else n += dw_tiles_of(HID, HID) + (((P.skip_mask >> i) & 1) ? dw_tiles_of(HID, P.kx) : 0);
  }
  return n + dw_tiles_of(HALF, HID) + dw_tiles_of(HALF, P.kd) + dw_tiles_of(HALF, P.emb_dim) +
         dw_tiles_of(DRGB_LD, HALF);
}

// Lay the scratch out from base (or only measure it, base == nullptr);
// returns its size in bytes.
inline long long carve(char* base, const FieldArgs& P, long long tiles, int n_vecs, Scratch* s) {
  const long long rows = tiles * TILE_M;
  long long off = 0;
  auto take = [&](long long bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const long long b = sizeof(__nv_bfloat16);
  s->h = reinterpret_cast<__nv_bfloat16*>(take(P.num_layers * rows * HID * b));
  s->dpre = reinterpret_cast<__nv_bfloat16*>(take(P.num_layers * rows * HID * b));
  s->encx = reinterpret_cast<__nv_bfloat16*>(take(rows * P.kx * b));
  s->encd = reinterpret_cast<__nv_bfloat16*>(take(rows * P.kd * b));
  s->happ = reinterpret_cast<__nv_bfloat16*>(take(rows * HALF * b));
  s->dapp = reinterpret_cast<__nv_bfloat16*>(take(rows * HALF * b));
  s->ddir = reinterpret_cast<__nv_bfloat16*>(take(rows * HALF * b));
  s->drgb = reinterpret_cast<__nv_bfloat16*>(take(rows * DRGB_LD * b));
  s->embr = reinterpret_cast<__nv_bfloat16*>(take(rows * P.emb_dim * b));
  s->dirg = reinterpret_cast<unsigned char*>(take(rows * HALF));
  s->nv = n_vecs + 1;
  s->part = reinterpret_cast<float*>(take(tiles * s->nv * (long long)sizeof(float)));
  s->dw_tiles = count_dw_tiles(P);
  s->dwpart = reinterpret_cast<float*>(
      take((long long)DW_PARTS * s->dw_tiles * DW_TILE * DW_TILE * sizeof(float)));
  s->rows = rows;
  return off;
}

inline int rays_per_tile(long long s) { return (int)(TILE_M / s < MAX_RPC ? TILE_M / s : MAX_RPC); }

// The s_tile of the per-row kernel K8: a tile holds 128 independent rows.
constexpr long long ROW_TILES = 0;

// Units (rays of s samples, or rows) in one tile.
inline int units_per_tile(long long s) { return s == ROW_TILES ? TILE_M : rays_per_tile(s); }

// Shared memory of the tile kernels beyond Smem.
struct BwdSmem {
  float g_rgb[TILE_M * 3];     // per-row cotangent of the field's rgb
  float g_sig[TILE_M];         // ... and of its sigma
  float dpr[TILE_M * 3];       // d_pre_rgb
  float dsp[TILE_M];           // d_sigma_pre
  float dsum[MAX_RPC * HALF];  // per-ray sums of bf16(d_happ), for demb
  float half_sum[2][2 * HALF]; // bapp / bdir row sums of the two row halves
  float loss[MAX_RPC];         // per-ray loss terms (K4, K7, K9)
};

inline size_t bwd_smem_bytes(int n_comp) {
  // Smem | BwdSmem | per-warp composite scratch (alpha, T, w) of n_comp samples
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

// ------------------------------------------------------------- chain

// d_pre of one layer from the f32 d_in fragments of a gemm_tile<4> (plus the
// density term for the last trunk layer), gated by gate (> 0, bf16, row
// stride ldg; shared or device memory), stored as bf16 to out_s (shared,
// LDH) and out_g (device, HID); the f32 column sums go to part[b_off + col].
__device__ __forceinline__ void bwd_epilogue(const float (&acc)[M_TILES][4][4],
                                             const float* dsp, const float* wd,
                                             const __nv_bfloat16* gate, long long ldg,
                                             __nv_bfloat16* out_s, __nv_bfloat16* out_g,
                                             float* part_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = warp * 32 + nt * 8 + 2 * tig;
    const float wd0 = wd ? __ldg(wd + col) : 0.f, wd1 = wd ? __ldg(wd + col + 1) : 0.f;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < M_TILES; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + gid + 8 * h;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (wd) { v0 += dsp[row] * wd0; v1 += dsp[row] * wd1; }
        const __nv_bfloat162 g = *reinterpret_cast<const __nv_bfloat162*>(gate + row * ldg + col);
        const float d0 = __bfloat162float(g.x) > 0.f ? v0 : 0.f;
        const float d1 = __bfloat162float(g.y) > 0.f ? v1 : 0.f;
        s0 += d0;
        s1 += d1;
        const __nv_bfloat162 d = __floats2bfloat162_rn(d0, d1);
        *reinterpret_cast<__nv_bfloat162*>(out_s + row * LDH + col) = d;
        *reinterpret_cast<__nv_bfloat162*>(out_g + (long long)row * HID + col) = d;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (gid == 0) {
      part_b[col] = s0;
      part_b[col + 1] = s1;
    }
  }
}

// out[r][0..n) = A[r] @ W^T for the tile's rows r < nvalid (row stride ldo),
// A (128 x k, bf16, shared memory, row stride lda), W (n x k) row-major
// bf16 in device memory, n a multiple of 8 up to MAX_E, k of 16.  For the
// narrow products (n < 8 x WARPS) each warp owns 16 rows and every column.
__device__ void gemm_rows(const __nv_bfloat16* A, int lda, int k,
                          const __nv_bfloat16* __restrict__ W, int n, float* __restrict__ out,
                          long long ldo, int nvalid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int NT = MAX_E / 8;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  const __nv_bfloat16* arow = A + (warp * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + k0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 < n) {
        const __nv_bfloat16* w = W + (long long)(nt * 8 + gid) * k + k0 + 2 * tig;
        const uint32_t b[2] = {__ldg(reinterpret_cast<const unsigned int*>(w)),
                               __ldg(reinterpret_cast<const unsigned int*>(w + 8))};
        mma_bf16(acc[nt], a, b);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * 8 < n) {
      const int r = warp * 16 + gid, c = nt * 8 + 2 * tig;
      if (r < nvalid) {
        out[r * ldo + c] = acc[nt][0];
        out[r * ldo + c + 1] = acc[nt][1];
      }
      if (r + 8 < nvalid) {
        out[(r + 8) * ldo + c] = acc[nt][2];
        out[(r + 8) * ldo + c + 1] = acc[nt][3];
      }
    }
  }
}

// The transposed chain on one tile, after field_tile<ROWS>(..., stash) and
// with bs.g_rgb / bs.g_sig set for all 128 rows (zero on rows of no ray).
// cur holds the last trunk layer's output, nxt happ (already stashed); both
// are overwritten.  Writes the tile's d_pre residuals and its row sums to
// sc.part + tile * sc.nv.  Rays: demb for the valid rays (ray0.., nvalid),
// the sum over each ray's samples of bf16(d_happ) @ Wapp.  ROWS: demb for
// the valid rows, bf16(d_happ) @ Wapp per row on the tensor cores, and the
// rows' embeddings come from embx (bf16, row stride LDE).
template <bool ROWS = false>
__device__ void field_bwd_tile(const FieldArgs& P, const BwdWeights& W, Smem& sm, BwdSmem& bs,
                               const Scratch& sc, int tile, int s, int rpc, int nvalid,
                               __nv_bfloat16* cur, __nv_bfloat16* nxt,
                               float* __restrict__ demb_ray0,
                               const __nv_bfloat16* embx = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = P.num_layers, E = P.emb_dim;
  const long long row0 = (long long)tile * TILE_M;
  float* part = sc.part + (long long)tile * sc.nv;

  // rgb head and density head cotangents per row; stash d_pre_rgb and the
  // row's embedding for the GEMM pass
  for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float y = sm.rgb[r * 3 + c];
      const float v = bs.g_rgb[r * 3 + c] * y * (1.f - y);
      bs.dpr[r * 3 + c] = v;
      sc.drgb[(row0 + r) * DRGB_LD + c] = __float2bfloat16_rn(v);
    }
    for (int c = 3; c < DRGB_LD; ++c) sc.drgb[(row0 + r) * DRGB_LD + c] = __float2bfloat16_rn(0.f);
    const float sp = sm.sigma_pre[r];
    const float act = P.softplus ? 1.f / (1.f + expf(-sp)) : (sp > 0.f ? 1.f : 0.f);
    bs.dsp[r] = bs.g_sig[r] * act;
  }
  for (int idx = threadIdx.x; idx < TILE_M * E; idx += THREADS) {
    const int r = idx / E, k = idx - r * E;
    if constexpr (ROWS) {
      sc.embr[(row0 + r) * E + k] = embx[r * LDE + k];
    } else {
      const int j = r / s;
      sc.embr[(row0 + r) * E + k] = __float2bfloat16_rn(j < nvalid ? sm.emb[j * E + k] : 0.f);
    }
  }
  for (int idx = threadIdx.x; idx < MAX_RPC * HALF; idx += THREADS) bs.dsum[idx] = 0.f;
  __syncthreads();

  // brgb, bd (warp 0) and wd (one thread a column) row sums
  if (warp == 0) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, ad = 0.f;
    for (int r = lane; r < TILE_M; r += 32) {
      a0 += bs.dpr[r * 3 + 0]; a1 += bs.dpr[r * 3 + 1]; a2 += bs.dpr[r * 3 + 2];
      ad += bs.dsp[r];
    }
    a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2); ad = warp_sum(ad);
    if (lane == 0) {
      part[P.brgb_off + 0] = a0; part[P.brgb_off + 1] = a1; part[P.brgb_off + 2] = a2;
      part[P.bd_off] = ad;
    }
  }
  for (int col = threadIdx.x; col < HID; col += THREADS) {
    float a = 0.f;
    for (int r = 0; r < TILE_M; ++r) a += __bfloat162float(cur[r * LDH + col]) * bs.dsp[r];
    part[P.wd_off + col] = a;
  }

  // d_happ = bf16(d_pre_rgb) @ Wrgb (f32), d_hdir_pre = gate ? d_happ : 0;
  // thread (col, half of the rows).  nxt gets bf16(d_hdir_pre), or for
  // ROWS first bf16(d_happ), the A operand of demb, gated below.
  {
    const int col = threadIdx.x & (HALF - 1), half = threadIdx.x / HALF;
    const __nv_bfloat16* wrgb = P.mats + P.wrgb_off;
    const float w0 = __bfloat162float(wrgb[col]), w1 = __bfloat162float(wrgb[HALF + col]);
    const float w2 = __bfloat162float(wrgb[2 * HALF + col]);
    float sa = 0.f, sd = 0.f, js = 0.f;
    int jc = -1;
    for (int r = half * (TILE_M / 2); r < (half + 1) * (TILE_M / 2); ++r) {
      const float dh = bf16_round(bs.dpr[r * 3 + 0]) * w0 + bf16_round(bs.dpr[r * 3 + 1]) * w1 +
                       bf16_round(bs.dpr[r * 3 + 2]) * w2;
      const __nv_bfloat16 b = __float2bfloat16_rn(dh);
      sc.dapp[(row0 + r) * HALF + col] = b;
      if constexpr (!ROWS) {
        const int j = r / s;
        if (j != jc) {
          if (jc >= 0 && jc < rpc) atomicAdd(&bs.dsum[jc * HALF + col], js);  // <= 2 adds: exact order-free
          jc = j;
          js = 0.f;
        }
        js += __bfloat162float(b);
      }
      const float g = sc.dirg[(row0 + r) * HALF + col] ? dh : 0.f;
      const __nv_bfloat16 gb = __float2bfloat16_rn(g);
      nxt[r * LDH + col] = ROWS ? b : gb;
      sc.ddir[(row0 + r) * HALF + col] = gb;
      sa += dh;
      sd += g;
    }
    if (jc >= 0 && jc < rpc) atomicAdd(&bs.dsum[jc * HALF + col], js);
    bs.half_sum[half][col] = sa;
    bs.half_sum[half][HALF + col] = sd;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HALF; c += THREADS) {
    part[P.bapp_off + c] = bs.half_sum[0][c] + bs.half_sum[1][c];
    part[P.bdir_off + c] = bs.half_sum[0][HALF + c] + bs.half_sum[1][HALF + c];
  }
  if constexpr (ROWS) {
    // demb = bf16(d_happ) @ Wapp per row, then gate nxt in place:
    // bf16(gate ? d_happ : 0) = gate ? bf16(d_happ) : 0
    gemm_rows(nxt, LDH, HALF, W.mats_t + W.wt_off[L + 1], E, demb_ray0, E, nvalid);
    __syncthreads();
    for (int idx = threadIdx.x; idx < TILE_M * HALF; idx += THREADS) {
      const int r = idx / HALF, c = idx - r * HALF;
      if (!sc.dirg[(row0 + r) * HALF + c]) nxt[r * LDH + c] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
  } else {
    // demb = (sum over the ray's samples of bf16(d_happ)) @ Wapp
    const __nv_bfloat16* wapp = P.mats + P.wapp_off;
    for (int idx = threadIdx.x; idx < nvalid * E; idx += THREADS) {
      const int j = idx / E, e = idx - j * E;
      float a = 0.f;
      for (int c = 0; c < HALF; ++c) a += bs.dsum[j * HALF + c] * __bfloat162float(wapp[c * E + e]);
      demb_ray0[(long long)j * E + e] = a;
    }
  }

  // dir layer: d_h = bf16(d_hdir_pre) @ Wdir[:, :HID] + d_sigma_pre * wd,
  // gated by the last trunk layer's output (cur, overwritten in place)
  float acc[M_TILES][4][4];
  gemm_tile<4>(nxt, LDH, HALF, nxt, LDH, 0, W.mats_t + W.wt_off[L], warp * 32, acc);
  const long long lstride = sc.rows * HID;
  bwd_epilogue(acc, bs.dsp, P.vecs + P.wd_off, cur, LDH, cur,
               sc.dpre + (L - 1) * lstride + row0 * HID, part + P.b_off[L - 1]);

  // trunk, reversed: d_pre_{i-1} = gate_{i-1} (bf16(d_pre_i) @ W_i[:, :HID])
  __nv_bfloat16* dcur = cur;
  __nv_bfloat16* dnxt = nxt;
  for (int i = L - 1; i >= 1; --i) {
    __syncthreads();
    gemm_tile<4>(dcur, LDH, HID, dcur, LDH, 0, W.mats_t + W.wt_off[i], warp * 32, acc);
    bwd_epilogue(acc, nullptr, nullptr, sc.h + (i - 1) * lstride + row0 * HID, HID, dnxt,
                 sc.dpre + (i - 1) * lstride + row0 * HID, part + P.b_off[i - 1]);
    __nv_bfloat16* t = dcur; dcur = dnxt; dnxt = t;
  }
}

// ------------------------------------------------------------- pass 2: dW

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
template <int PARTS = DW_PARTS>
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
template <int PARTS = DW_PARTS>
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

// ------------------------------------------------------------- pass 3: row sums

__global__ void reduce_parts(const float* __restrict__ part, int tiles, int nv, int n_vecs,
                             float* gvecs, float* loss) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nv) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += part[(long long)t * nv + j];
  if (j < n_vecs) gvecs[j] += s;
  else if (loss != nullptr) *loss += s;
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

// Passes 2 and 3 for the `tiles` tiles of one pass: add this pass's
// gradients into gmats / gvecs (and its loss into *loss).
inline int finish_pass(const FieldArgs& P, const Scratch& sc, int tiles, float* gmats,
                       float* gvecs, float* loss, int n_vecs, cudaStream_t stream) {
  DwJobs J;
  J.n = 0;
  J.rows = (long long)tiles * TILE_M;
  const long long ls = sc.rows * HID;
  const int L = P.num_layers, kx = P.kx, kd = P.kd, E = P.emb_dim;
  int n = 0;
  for (int i = 0; i < L; ++i) {
    const __nv_bfloat16* d = sc.dpre + i * ls;
    float* c = gmats + P.w_off[i];
    if (i == 0) {
      add_job(J, n, d, HID, HID, HID, sc.encx, kx, kx, c, kx);
    } else {
      const bool skip = (P.skip_mask >> i) & 1;
      const int ldc = skip ? HID + kx : HID;
      add_job(J, n, d, HID, HID, HID, sc.h + (i - 1) * ls, HID, HID, c, ldc);
      if (skip) add_job(J, n, d, HID, HID, HID, sc.encx, kx, kx, c + HID, ldc);
    }
  }
  add_job(J, n, sc.ddir, HALF, HALF, HALF, sc.h + (L - 1) * ls, HID, HID, gmats + P.wdir_off,
          HID + kd);
  add_job(J, n, sc.ddir, HALF, HALF, HALF, sc.encd, kd, kd, gmats + P.wdir_off + HID, HID + kd);
  add_job(J, n, sc.dapp, HALF, HALF, HALF, sc.embr, E, E, gmats + P.wapp_off, E);
  add_job(J, n, sc.drgb, DRGB_LD, DRGB_LD, 3, sc.happ, HALF, HALF, gmats + P.wrgb_off, HALF);
  if (n != sc.dw_tiles) return ERR_META;
  dw_kernel<<<dim3(n, DW_PARTS), DW_THREADS, 0, stream>>>(J, sc.dwpart, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_el = (long long)n * DW_TILE * DW_TILE;
  dw_reduce<<<(unsigned)((n_el + 255) / 256), 256, 0, stream>>>(J, sc.dwpart, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_parts<<<(sc.nv + 255) / 256, 256, 0, stream>>>(sc.part, tiles, sc.nv, n_vecs, gvecs,
                                                         loss);
  return (int)cudaGetLastError();
}

// What K8 and K9 set up: the layout records, the shape checks, the scratch
// of one pass and the pass sizes, for R rays of s_tile samples in a tile's
// rows (K9: max(Sc, Sf)), or R rows for s_tile = ROW_TILES (K8).
struct BwdCall {
  FieldArgs P;
  BwdWeights W;
  Scratch sc;
  int rpc, tiles_pass;
  long long tiles_total;
};

inline int bwd_setup(const long long* meta, long long n_meta, const void* mats, const float* vecs,
                     long long E, const void* mats_t, const long long* meta_t, long long n_meta_t,
                     long long R, long long s_tile, void* scratch, long long scratch_bytes,
                     long long n_vecs, BwdCall* c) {
  int err = parse_meta(meta, n_meta, mats, vecs, E, &c->P);
  if (err) return err;
  err = parse_meta_t(meta_t, n_meta_t, c->P, mats_t, &c->W);
  if (err) return err;
  if (c->P.emb_dim % 8 || 2 * c->P.num_layers + 4 > MAX_JOBS || n_vecs < 1 || s_tile < 0 ||
      s_tile > TILE_M || R < 0)
    return ERR_SHAPE;
  c->rpc = units_per_tile(s_tile);
  c->tiles_total = (R + c->rpc - 1) / c->rpc;
  c->tiles_pass = (int)(c->tiles_total < MAX_TILES_PER_PASS ? c->tiles_total : MAX_TILES_PER_PASS);
  if (carve(static_cast<char*>(scratch), c->P, c->tiles_pass, (int)n_vecs, &c->sc) > scratch_bytes)
    return ERR_SHAPE;
  return 0;
}

// Run the passes: for each slice of at most tiles_pass tiles, clear its row
// sums, launch(n_tiles, first_ray) the tile kernel, then passes 2 and 3.
template <class Launch>
inline int run_passes(const BwdCall& c, const void* kernel, size_t smem, float* gmats,
                      float* gvecs, float* loss, int n_vecs, cudaStream_t stream, Launch launch) {
  if (smem > 232448) return ERR_SHAPE;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (long long t0 = 0; t0 < c.tiles_total; t0 += c.tiles_pass) {
    const int nt = (int)(c.tiles_total - t0 < c.tiles_pass ? c.tiles_total - t0 : c.tiles_pass);
    e = cudaMemsetAsync(c.sc.part, 0, sizeof(float) * nt * c.sc.nv, stream);
    if (e != cudaSuccess) return (int)e;
    launch(nt, t0 * c.rpc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int err = finish_pass(c.P, c.sc, nt, gmats, gvecs, loss, n_vecs, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace danerf
