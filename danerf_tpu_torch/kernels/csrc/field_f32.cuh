// The forward NeRF-W field in f32 (use_bf16=False) for the f32 variants of
// the serving kernels, K2 (march_f32.cu) and K5 (merged_f32.cu), and of the
// per-sample field K1 (mlp_fwd_f32.cu): the counterpart of
// danerf_tpu/kernels/fused_mlp.py _field_from_enc with cdt = float32, as
// _render_kernel, _merged_kernel and _fwd_kernel run it when cfg.use_bf16
// is off.  The argument record, its parsing, the encoder (encode_cols), the
// merge and the composite come from field.cuh.  The f32 backward tile
// (field_bwd_f32.cuh) runs the same block with a stash hook (field_block's
// Stash) and its transposed chain on the same FFMA slice (ffma_slice).
//
// Numerics: the JAX f32 configuration's.  Encodings, activations, the
// appearance term and every product are f32; every product is an f32
// fused multiply-add on the CUDA cores (FFMA), so nothing rounds below f32
// (a TF32 tensor-core pass would keep ~3 decimal digits).  The order of
// the sums differs from the plain version's (one FFMA chain a thread over
// each 32-deep K slice, in K order; the heads summed over the lanes by a
// butterfly).  happ = (relu(hdir_pre) + emb@Wapp) + bapp, rgb =
// sigmoid(happ@Wrgb + brgb), sigma = relu or softplus of h@wd + bd, as in
// the JAX order.
//
// Bound on an H100: operations, at FP32's 67 TFLOP/s (no tensor core).
// 527,872 MACs a sample (534,528 with time), so K2's 65,536-ray x
// 64-sample chunk is 4.43 TFLOP, 66.1 ms; K1's 131,072 rows 0.14 TFLOP,
// 2.1 ms.
//
// Design: a simple SIMT tile, right first (making it fast is later work).
// A block of 256 threads (8 warps) runs the field on MB = 64 rows at a
// time: warp w owns rows 8w..8w+7 and lane l the output columns l + 32j,
// so a thread keeps an 8 x 8 block of accumulators (8 x 4 on the N = 128
// dir layer and appearance projection), reads its 8 rows of A as two
// broadcast 16-byte loads and 8 weights a K step with no bank conflict:
// 64 FFMA to 10 shared loads.  A is column-major in shared memory (column
// c at c * AP, AP = 68 floats, so the epilogue's 16-byte stores of a
// thread's rows are conflict-free too): the trunk activations in place
// (each layer's output overwrites its input after a block barrier), the
// encodings beside them, each row's embedding.  The weights stream in
// 32-deep K slices of one matrix's whole N through two shared-memory
// stages with cp.async, the next slice (across layer boundaries) in flight
// while the block computes on the current one; the wrapper hands the
// matrices transposed, (K, N) row-major at the packed offsets, so a slice
// is one contiguous 32 KB run.  One barrier a slice.  Shared memory: the
// stages 64 KB, activations 68 KB, encodings 29.75 KB, embeddings 17 KB,
// the tile's rows and rays 2.7 KB, K1's rows 1.75 KB: 187,616 bytes, one
// block an SM.
//
// Tiles: K2 and K5 keep the bf16 kernels' shapes, a tile of rpc rays of s
// samples (rpc = min(128 / s, 8), up to 128 rows), whose rows run through
// the field as two 64-row blocks (one when they fill 64 or fewer) before
// one warp a ray composites (and K5 merges, its merge arrays in the
// activation buffer); K1's tile is one block of 64 independent rows.  The
// grid strides over the tiles, at most the blocks that fit on the card at
// once.

#pragma once

#include "field.cuh"

namespace danerf {
namespace f32 {

constexpr int MB = 64;            // rows of an MLP block
constexpr int THREADS = 256;      // 8 warps, 8 rows each
constexpr int KSF = 32;           // K slice of a stage
constexpr int AP = MB + 4;        // column pitch (floats) of the column-major A buffers

struct Smem {
  float w[2][KSF * HID];          // weight stages: row k of a slice at k * N
  float act[HID * AP];            // trunk activations; K5's merge arrays between tiles
  float encx[MAX_KX * AP];        // position (+ time) encoding
  float encd[MAX_KD * AP];        // direction encoding
  float emb[MAX_E * AP];          // each row's embedding
  float rgb[TILE_M * 3], sigma[TILE_M], z[TILE_M];  // the tile's rows
  float o[MAX_RPC * 3], d[MAX_RPC * 3], t[MAX_RPC];  // its rays (K1: unused)
  float rows[MB * 7];             // K1: the block's points, directions and times
};
constexpr size_t SMEM_BYTES = sizeof(Smem);
static_assert(SMEM_BYTES <= 232448, "the f32 tile exceeds the 227 KB a block may use");
static_assert(MERGE_MAX <= sizeof(Smem::act), "the merge arrays must fit in sm.act");

// The rays (K2: samples z; K5: its fine samples z and the coarse pre_z,
// pre_f) or, for K1, the rows (o the points, s = 1, no z) of a launch.
struct Rays32 {
  const float* o;
  const float* d;
  const float* emb;
  const float* t;
  const float* z;
  const float* pre_z;
  const float* pre_f;
  long long R, n_tiles;
  int s, rpc, pre_n;
};

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ Smem& smem_f32() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>(smem_raw);
}

// Matrix m of a block's chain: the trunk layers 0..L-1 (N = 256), the dir
// layer L and the appearance projection L + 1 (N = 128), each (K, N)
// row-major in wt at its packed offset.
struct Mat {
  const float* w;
  int k, n;
};

__device__ __forceinline__ Mat mat_of(const FieldArgs& P, const float* wt, int m) {
  const int L = P.num_layers;
  if (m < L) {
    const int k = m == 0 ? P.kx : (((P.skip_mask >> m) & 1) ? HID + P.kx : HID);
    return {wt + P.w_off[m], k, HID};
  }
  if (m == L) return {wt + P.wdir_off, HID + P.kd, HALF};
  return {wt + P.wapp_off, P.emb_dim, HALF};
}

// The A operand of slice k0 of matrix m: layer 0 reads enc_x, a skip layer
// [h, enc_x], the dir layer [h, enc_d], the projection the embeddings.
__device__ __forceinline__ const float* a_of(const FieldArgs& P, const Smem& sm, int m, int k0) {
  const int L = P.num_layers;
  if (m == 0) return sm.encx + k0 * AP;
  if (m == L + 1) return sm.emb + k0 * AP;
  if (k0 < HID) return sm.act + k0 * AP;
  return (m == L ? sm.encd : sm.encx) + (k0 - HID) * AP;
}

// The weight stream of a block's chain: slice (m, k0) of the chain lands in
// stage q & 1 for the q-th slice; load() starts the next one's copy.
struct Stream {
  const FieldArgs& P;
  const float* wt;
  Smem& sm;
  int m = 0, k0 = 0, q = 0;  // the next slice to load, and its position

  __device__ __forceinline__ void load() {
    if (m > P.num_layers + 1) return;
    const Mat mt = mat_of(P, wt, m);
    const int kw = min(KSF, mt.k - k0);
    const float4* src = reinterpret_cast<const float4*>(mt.w + (long long)k0 * mt.n);
    float4* dst = reinterpret_cast<float4*>(sm.w[q & 1]);
    for (int i = threadIdx.x; i < kw * mt.n / 4; i += THREADS) cp_async16(dst + i, src + i);
    cp_async_commit();
    ++q;
    k0 += KSF;
    if (k0 >= mt.k) {
      ++m;
      k0 = 0;
    }
  }
};

// acc += one K slice's products for the thread's 8 rows and NJ columns
// (lane + 32 j): A column-major at a (the thread's rows, pitch AP), the
// slice's kw rows of B at b (the lane's column, pitch 32 NJ).
template <int NJ>
__device__ __forceinline__ void ffma_slice(float (&acc)[8][NJ], const float* a, const float* b,
                                           int kw) {
#pragma unroll 4
  for (int k = 0; k < kw; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * AP);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * AP + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[k * 32 * NJ + 32 * j];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
  }
}

// acc (+)= A @ W_m^T for the thread's 8 rows and NJ columns (lane + 32 j)
// over matrix m's slices: wait for a slice, one barrier (it has landed for
// every thread, and every thread is done with the other stage), start the
// next one's copy, compute.
template <int NJ>
__device__ __forceinline__ void mma_mat(float (&acc)[8][NJ], Stream& st, int m) {
  const FieldArgs& P = st.P;
  const int w8 = (threadIdx.x >> 5) * 8, lane = threadIdx.x & 31;
  const int K = mat_of(P, st.wt, m).k;
  for (int k0 = 0; k0 < K; k0 += KSF) {
    const int stage = (st.q - 1) & 1;  // the slice started last is this one
    cp_async_wait_all();
    __syncthreads();
    st.load();
    ffma_slice<NJ>(acc, a_of(P, st.sm, m, k0) + w8, st.sm.w[stage] + lane, min(KSF, K - k0));
  }
}

// The f32 sink of encode_cols: column c of row r at c * AP + r.
struct F32Sink {
  float* xs;
  float* ds;
  __device__ __forceinline__ void x(int row, int col, float v) { xs[col * AP + row] = v; }
  __device__ __forceinline__ void d(int row, int col, float v) { ds[col * AP + row] = v; }
};

// What the forward keeps for a backward pass: nothing (the forward kernels);
// field_bwd_f32.cuh's StashRes keeps each trunk layer's output, sigma_pre,
// relu(hdir_pre) and happ.  trunk: the thread's 8 rows (w8..) of trunk layer
// m's output column c; sigma_pre: row's; head: relu(hdir_pre) and happ of
// row, column c.
struct NoStash {
  __device__ __forceinline__ void trunk(int, int, int, const float (&)[8]) const {}
  __device__ __forceinline__ void sigma_pre(int, float) const {}
  __device__ __forceinline__ void head(int, int, float, float) const {}
};

// The field of one block of MB rows.  enc(sm) fills sm.encx, sm.encd and
// sm.emb for the block's rows (every thread calls it); the rows' rgb and
// sigma go to rgb_out[r * 3 + k], sig_out[r] for r < MB; stash keeps the
// residuals a backward pass needs.  The first slice streams in while the
// block encodes.
template <class Enc, class Stash = NoStash>
__device__ __forceinline__ void field_block(const FieldArgs& P, const float* wt, Smem& sm,
                                            const Enc& enc, float* rgb_out, float* sig_out,
                                            const Stash& stash = Stash()) {
  const int w8 = (threadIdx.x >> 5) * 8, lane = threadIdx.x & 31;
  const int L = P.num_layers;
  __syncthreads();  // every thread is done with the last block's buffers
  Stream st{P, wt, sm};
  st.load();
  enc(sm);
  float dsum[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) dsum[r] = 0.f;
  for (int m = 0; m < L; ++m) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    mma_mat<8>(acc, st, m);
    __syncthreads();  // every thread has read this layer's input
    const float* bias = P.vecs + P.b_off[m];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane + 32 * j;
      const float b = __ldg(bias + c);
      float h[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) h[r] = fmaxf(acc[r][j] + b, 0.f);
      stash.trunk(m, c, w8, h);
      *reinterpret_cast<float4*>(sm.act + c * AP + w8) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(sm.act + c * AP + w8 + 4) = make_float4(h[4], h[5], h[6], h[7]);
      if (m == L - 1) {
        const float wd = __ldg(P.vecs + P.wd_off + c);
#pragma unroll
        for (int r = 0; r < 8; ++r) dsum[r] = fmaf(h[r], wd, dsum[r]);
      }
    }
  }
  const float bd = __ldg(P.vecs + P.bd_off);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v = warp_sum(dsum[r]) + bd;
    if (lane == 0) {
      sig_out[w8 + r] = P.softplus ? fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) : fmaxf(v, 0.f);
      stash.sigma_pre(w8 + r, v);
    }
  }

  // dir branch and rgb head: happ = (relu([h, enc_d] @ Wdir^T + bdir) +
  // emb @ Wapp^T) + bapp; rgb = sigmoid(happ @ Wrgb^T + brgb)
  float hd[8][4], ha[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) hd[r][j] = ha[r][j] = 0.f;
  mma_mat<4>(hd, st, L);
  mma_mat<4>(ha, st, L + 1);
  const float* wrgb = wt + P.wrgb_off;  // (HALF, 3): transposed
  float cs[8][3];
#pragma unroll
  for (int r = 0; r < 8; ++r) cs[r][0] = cs[r][1] = cs[r][2] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = lane + 32 * j;
    const float bdir = __ldg(P.vecs + P.bdir_off + c), bapp = __ldg(P.vecs + P.bapp_off + c);
    const float w0 = __ldg(wrgb + c * 3), w1 = __ldg(wrgb + c * 3 + 1),
                w2 = __ldg(wrgb + c * 3 + 2);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float hdir = fmaxf(hd[r][j] + bdir, 0.f);
      const float happ = (hdir + ha[r][j]) + bapp;
      stash.head(w8 + r, c, hdir, happ);
      cs[r][0] = fmaf(happ, w0, cs[r][0]);
      cs[r][1] = fmaf(happ, w1, cs[r][1]);
      cs[r][2] = fmaf(happ, w2, cs[r][2]);
    }
  }
  const float* brgb = P.vecs + P.brgb_off;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = warp_sum(cs[r][k]);
      if (lane == 0) rgb_out[(w8 + r) * 3 + k] = 1.f / (1.f + expf(-(v + __ldg(brgb + k))));
    }
}

// The encoder of rows row0.. of a tile of rays (rows of ray j = row / s of
// the tile's sm.o, sm.d, sm.t, depths sm.z; n_rays of them valid): their
// encodings and their rays' embeddings (emb, E wide, from ray ray0).
struct RayEnc {
  const FieldArgs& P;
  const float* emb;
  long long ray0;
  int row0, s, n_rays;

  __device__ __forceinline__ void operator()(Smem& sm) const {
    F32Sink sink{sm.encx, sm.encd};
    const int groups = P.pos_levels + P.dir_levels + 1, E = P.emb_dim;
    for (int it = threadIdx.x; it < MB * groups; it += THREADS) {
      const int r = it & (MB - 1), row = row0 + r, j = row / s;
      const bool valid = j < n_rays;
      const int jj = valid ? j : 0;
      encode_cols(P, sink, r, it / MB, valid, sm.o + jj * 3, sm.d + jj * 3,
                  sm.z + (valid ? row : 0), sm.t + jj);
    }
    for (int i = threadIdx.x; i < MB * E; i += THREADS) {
      const int r = i & (MB - 1), k = i / MB, j = (row0 + r) / s;
      sm.emb[k * AP + r] = j < n_rays ? emb[(ray0 + j) * E + k] : 0.f;
    }
  }
};

// The encoder of a block of independent rows row0.. (n valid; K1 and K8):
// the rows' inputs from sm.rows (x, d, t; load_rows), their embeddings from
// device memory.
struct RowEnc {
  const FieldArgs& P;
  const float* emb;
  long long row0;
  int n;

  __device__ __forceinline__ void operator()(Smem& sm) const {
    const float* xs = sm.rows;
    const float* ds = xs + 3 * MB;
    const float* ts = ds + 3 * MB;
    F32Sink sink{sm.encx, sm.encd};
    const int groups = P.pos_levels + P.dir_levels + 1, E = P.emb_dim;
    for (int it = threadIdx.x; it < MB * groups; it += THREADS) {
      const int r = it & (MB - 1);
      encode_cols(P, sink, r, it / MB, r < n, xs + r * 3, ds + r * 3, nullptr, ts + r);
    }
    for (int i = threadIdx.x; i < MB * E; i += THREADS) {
      const int r = i & (MB - 1), k = i / MB;
      sm.emb[k * AP + r] = r < n ? emb[(row0 + r) * E + k] : 0.f;
    }
  }
};

// Load the points, directions and times of the n rows row0.. (zeros past n)
// into sm.rows for RowEnc; the next field_block's first barrier publishes
// them.  sm.rows is read only by RowEnc, so the last block's field_block is
// done with it once any thread returns from it.
__device__ __forceinline__ void load_rows(Smem& sm, const Rays32& rows, long long row0, int n) {
  float* xs = sm.rows;
  float* ds = xs + 3 * MB;
  float* ts = ds + 3 * MB;
  for (int i = threadIdx.x; i < 3 * MB; i += THREADS) {
    xs[i] = i / 3 < n ? rows.o[row0 * 3 + i] : 0.f;
    ds[i] = i / 3 < n ? rows.d[row0 * 3 + i] : 0.f;
  }
  for (int i = threadIdx.x; i < MB; i += THREADS)
    ts[i] = (rows.t != nullptr && i < n) ? rows.t[row0 + i] : 0.f;
}

// Load tile c's rays: origins, directions, times (zeros past R) and each
// row's depth z[r * s + sample] (zeros past the tile's valid rays).
__device__ __forceinline__ void load_rays(Smem& sm, const Rays32& rays, long long ray0,
                                          int n_rays) {
  for (int i = threadIdx.x; i < rays.rpc * 3; i += THREADS) {
    const bool ok = i / 3 < n_rays;
    sm.o[i] = ok ? rays.o[ray0 * 3 + i] : 0.f;
    sm.d[i] = ok ? rays.d[ray0 * 3 + i] : 0.f;
  }
  for (int j = threadIdx.x; j < rays.rpc; j += THREADS)
    sm.t[j] = (rays.t != nullptr && j < n_rays) ? rays.t[ray0 + j] : 0.f;
  for (int row = threadIdx.x; row < TILE_M; row += THREADS)
    sm.z[row] = row < n_rays * rays.s ? rays.z[ray0 * rays.s + row] : 0.f;
}

// The field at every row of tile c of rays (its rays loaded by load_rays):
// sm.rgb and sm.sigma of the tile's rows, valid behind a barrier.
__device__ __forceinline__ void field_rays(const FieldArgs& P, const float* wt, Smem& sm,
                                           const Rays32& rays, long long ray0, int n_rays) {
  const int rows = n_rays * rays.s;
  for (int row0 = 0; row0 < rows; row0 += MB)
    field_block(P, wt, sm, RayEnc{P, rays.emb, ray0, row0, rays.s, n_rays}, sm.rgb + row0 * 3,
                sm.sigma + row0);
  __syncthreads();
}

// ------------------------------------------------------------------ host

// Host set-up shared by the f32 kernels: the kernel's shared memory limit
// (smem bytes a block) and the grid (the blocks that fit on the card at
// once, at most one a tile).
template <class Kernel>
inline int launch_setup(Kernel kernel, long long n_tiles, unsigned* grid,
                        size_t smem = SMEM_BYTES) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long most = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(n_tiles < most ? n_tiles : most);
  return 0;
}

}  // namespace f32
}  // namespace danerf
