// The reverse walk of the split NeRF training step for Hopper (sm_90a): a
// hand-written backward through the compositing and the MLP, on the forward
// sweep's stash.
//
// Replaces, with fused_render.cu's STASH sweep and grad_gemm.cu, the Pallas
// TPU kernels of sfm_nerf_tpu/kernels/fused_train.py:
// - `fused_mse_loss` and `fused_mse_loss_weights` (`_make_step_kernel`),
//   under the cotangent g = (rgb - target) * 2 / (3 N), which this kernel
//   makes from the forward sweep's rgb;
// - `fused_render_train`'s backward (`_make_bwd_kernel`), under the
//   caller's cotangent g (N, 3) (g_in).  JAX's backward recomputes each
//   chunk from tb; here the STASH sweep that runs just before recomputes
//   the whole ray group, tb included.
// Per ray it reads the forward sweep's stash (fused_render.cu STASH: every
// layer input, the per-point density and colours, tb), walks the ray's
// 64-point records in reverse and writes each layer's bf16 output cotangent
// D to a cotangent stash, which grad_gemm.cu turns into the weight grads
// (sum over points of A^T D).  Bias grads and rgb1's direction rows stay
// here, in per-warpgroup partials; reduce_add_kernel adds partials to the
// grads in a fixed order.
//
// Bound on this card: bytes.  For every 64-point record at hidden 256 the
// walk reads the eleven layer inputs its masks need (42 blocks of 8 KB) and
// writes twelve output cotangents (44 blocks): 11.0 KB a point, so a step
// of 8,192 rays x 256 samples (2,097,152 points) moves 23.1 GB, 6.9 ms at
// 3.35 TB/s.  Its products, D W^T for every layer, are one forward's worth
// (655,488 MACs a point), 2.78 ms at 989 TFLOP/s dense bf16.  Through L2
// it moves more: every 128 points stream the layers' weights again (21 GB
// a step) beside those 23 GB, and that, not HBM, sets its pace on an H100.
//
// What the design does about it (the machine of sm90_mlp.cuh):
// - one persistent block per SM: two consumer warpgroups, each walking its
//   own rays, and a producer warpgroup whose one lane streams the weights;
// - the products D W^T run on wgmma, m64 x (the layer's input width) x k16,
//   with D read K-major from shared memory and W^T read MN-major from the
//   render kernel's own weight tile image (render_tile_image): a tile there
//   holds each weight column as a 128-byte row of 64 weight-row values, so
//   rows [k0, k0 + kc) of every 64-row tile of a layer, bulk-copied side by
//   side into a ring slot, are the MN-major image of W^T's rows [k0, k0 + kc)
//   (kernels/fused_train.py:walk_plan lists the slots, 32 weight columns
//   each, so four 16 KB slots are in flight; no new upload);
// - the stash records are the swizzled 64-row images wgmma reads, so a
//   warpgroup bulk-copies each layer input (the ReLU mask) into a shared
//   buffer on an mbarrier as soon as the buffer is free, a layer ahead, and
//   bulk-stores each cotangent from the buffer it was built in;
// - the epilogue reads the mask with ldmatrix in the accumulators' own
//   fragment layout and writes (D W^T) where A > 0, rounded to bf16, over
//   it with stmatrix: the buffer becomes the next layer's D in place;
// - the bias grads are the column sums of each D's bf16 values, summed in
//   f32 over the record's rows in order by the thread that owns the
//   columns, into the warpgroup's partial row: no atomics, and the ray ->
//   warpgroup map is fixed, so the grads are bit-equal from run to run;
// - each warpgroup composites its own ray, 128 samples a thread each, then
//   walks the chunk's two records back; the other warpgroup's products run
//   meanwhile.
//
// Numerics kept from the TPU kernels: one_m = expf(-x) + 1e-10, never
// 1 - alpha + 1e-10; dL/dalpha = q T - R / one_m with R the strict suffix
// sum of q w carried across chunks in reverse; the exclusive transmittance
// as T expf(csum + x); dsigma = dalpha * delta * expf(-x); softplus' =
// 1 - expf(-density), relu mask on the legacy arch; a white background
// shifts q by -sum(g); cotangents are rounded to bf16 where they enter a
// product, sums and biases stay f32.
//
// MIP (the mip arch, the cone step of kernels/fused_train.py): distances are
// the interval lengths (t1 - t0) |d| over S + 1 edges a ray; the rgb head's
// cotangent is 1.002 s (1 - s) with s = (c + 0.001) / 1.002 from the stashed
// colour c; the bottleneck is linear, so rgb1's input cotangent takes no
// ReLU mask; the direction rows read mip-NeRF's encoding of d / |d|.

#include "nerf_device.cuh"
#include "sm90_mlp.cuh"

namespace {

using nerf::KParams;
using sm90::KB_BYTES;

constexpr int IMG_BLOCK = 64 * 64;   // bf16 elements of one 64-row x 64-column image block
constexpr int BUF_BLOCKS = 4;        // blocks of a cotangent buffer: 256 columns
constexpr int BUF_BYTES = BUF_BLOCKS * KB_BYTES;
constexpr int MAX_WSTAGES = 160;     // ring slots of one record's walk
constexpr int STAGE_INTS = 8;        // layer, k0, kc, pieces, 4 piece offsets
constexpr int WG_FLOATS = 1024;      // per-warpgroup small arrays (Wgs)

struct WStage {
  short layer, k0, kc, pieces;   // W^T rows [k0, k0 + kc) of packed layer ``layer``
  int off, stride;               // piece p at element off + p stride of the tile image
};

// kernels/fused_train.py:_walk_ints, and the shared-memory layout
struct Walk {
  WStage slot[MAX_WSTAGES];
  int first[nerf::MAX_LAYERS], count[nerf::MAX_LAYERS];   // each layer's stages
  int cot_off[nerf::MAX_LAYERS];                          // its D's first record block
  int n_stages, rec_act, enc_kb, act_kb, rec_cot, nb;
  int stage_bytes, stages;
  int buf, head, small, bars, ring, total;   // bytes from the 1024-aligned base
};

struct RevArgs {
  const float *dirs, *z, *tb;
  const float* cones;          // (rays, 2) radius, |d| for the mip arch, or null
  const float *rgb, *target;   // the MSE cotangent's inputs, when g_in is null
  const float* g_in;           // the caller's cotangent (rays, 3), or null
  const __nv_bfloat16* stash_act;   // the forward sweep's records (rays, 2 n_chunks, rec_act)
  const float4* stash_pt;           // (rays, 2 n_chunks, 64): density, r, g, b
  __nv_bfloat16* stash_cot;         // (rays, 2 n_chunks, rec_cot) cotangent records, written
  float* partials;   // (2 blocks, grad_stride): rgb1's direction rows (dir_dim x 128), biases
  int n_rays, n_sample, n_chunks, grad_stride;
  float gscale;
};

// layout: rec_act, enc_kb, act_kb, rec_cot, n_layers cotangent block offsets,
// n_stages, then STAGE_INTS per stage.  Checks the plan against the network
// and lays out shared memory.
inline cudaError_t parse_walk(const KParams& P, const int* layout, Walk* w) {
  const int nl = P.n_layers;
  if (P.layers[0].kind != nerf::K_FC1 || P.layers[nl - 1].kind != nerf::K_RGB2 ||
      P.layers[nl - 2].kind != nerf::K_RGB1 || P.layers[nl - 3].kind != nerf::K_DENSFEAT ||
      P.layers[nl - 1].N != 16 || P.layers[nl - 2].N != nerf::RGB1_N ||
      P.layers[nl - 3].N != P.hidden + 16 || P.dir_dim > nerf::RGB1_N)
    return cudaErrorInvalidValue;
  w->rec_act = layout[0];
  w->enc_kb = layout[1];
  w->act_kb = layout[2];
  w->rec_cot = layout[3];
  for (int i = 0; i < nl; ++i) {
    w->cot_off[i] = layout[4 + i];
    w->first[i] = w->count[i] = 0;
  }
  const int* q = layout + 4 + nl;
  w->n_stages = q[0];
  if (w->n_stages < nl - 1 || w->n_stages > MAX_WSTAGES) return cudaErrorInvalidValue;
  w->nb = (P.hidden + 63) / 64;
  int prev = nl, next_k = 0, bytes = 0;
  for (int s = 0; s < w->n_stages; ++s) {
    const int* r = q + 1 + s * STAGE_INTS;
    WStage& st = w->slot[s];
    st = WStage{(short)r[0], (short)r[1], (short)r[2], (short)r[3], r[4], r[5] - r[4]};
    if (st.layer != prev) {   // layers n-1 down to 1, each once, in order
      if (st.layer != prev - 1 || st.layer < 1 || (prev < nl && next_k != P.layers[prev].N))
        return cudaErrorInvalidValue;
      w->first[st.layer] = s;
      prev = st.layer;
      next_k = 0;
    }
    ++w->count[st.layer];
    // a layer's slots cover its output columns in order
    const int pieces = st.layer == nl - 1 ? nerf::RGB1_N / 64 : w->nb;
    if (st.kc < 16 || st.kc > 64 || st.kc % 16 || st.k0 != next_k ||
        st.k0 + st.kc > P.layers[st.layer].N || st.pieces != pieces)
      return cudaErrorInvalidValue;
    next_k += st.kc;
    for (int p = 0; p < st.pieces; ++p)   // a pass's tiles lie side by side in the image
      if (r[4 + p] != st.off + p * st.stride || r[4 + p] % 64 || r[4 + p] < 0)
        return cudaErrorInvalidValue;
    if (st.pieces * st.kc * 128 > bytes) bytes = st.pieces * st.kc * 128;
  }
  if (prev != 1 || next_k != P.layers[1].N) return cudaErrorInvalidValue;
  w->stage_bytes = (bytes + 1023) & ~1023;
  int off = 0;
  w->buf = off;
  off += sm90::CONSUMERS * 2 * BUF_BYTES;
  w->head = off;
  off += sm90::CONSUMERS * KB_BYTES;
  w->small = off;
  off += sm90::CONSUMERS * WG_FLOATS * 4;
  w->bars = off;
  off += (2 * sm90::MAX_STAGES + 2 * sm90::CONSUMERS) * 8;
  off = (off + 1023) & ~1023;
  w->ring = off;
  w->stages = (sm90::SMEM_BUDGET - 1024 - off) / w->stage_bytes;
  if (w->stages > sm90::MAX_STAGES) w->stages = sm90::MAX_STAGES;
  if (w->stages < 2) return cudaErrorInvalidValue;
  w->total = off + w->stages * w->stage_bytes + 1024;
  return cudaSuccess;
}

// One consumer warpgroup: its thread, its two cotangent buffers (buffer b
// at buf + b BUF_BYTES), the head block past a buffer's 256 columns (shared
// addresses), the buffers' mbarriers (buffer b's at full + 8 b) and its
// small arrays.
struct Wgs {
  int g, tid, warp, lane;
  uint32_t buf, head, full;
  float* small;
  __device__ __forceinline__ float* drgb() const { return small; }          // 128 x 3
  __device__ __forceinline__ float* ddens() const { return small + 384; }   // 128
  __device__ __forceinline__ float* dext() const { return small + 512; }    // up to 128
  __device__ __forceinline__ float* ddir() const { return small + 640; }    // 128
  __device__ __forceinline__ float* red() const { return small + 768; }     // 8
};

// block b of a cotangent buffer: the head block past BUF_BLOCKS (only the
// density/feature head's cotangent at hidden 256 reaches it)
__device__ __forceinline__ uint32_t blk(const Wgs& w, uint32_t buf, int b) {
  return b < BUF_BLOCKS ? buf + b * KB_BYTES : w.head;
}

// byte offset of element (row, col) inside its 64-column block
__device__ __forceinline__ int in_block(int row, int col) {
  return row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// bf16x2 of (a, b) where the layer input m (bf16x2, a's in the low half) is
// above zero, else 0
__device__ __forceinline__ uint32_t masked(float a, float b, uint32_t m) {
  return bf16x2(__uint_as_float(m << 16) > 0.0f ? a : 0.0f,
                __uint_as_float(m & 0xffff0000u) > 0.0f ? b : 0.0f);
}

// The compositing backward of samples [128 c, 128 c + 128) of a ray, thread
// t sample 128 c + t (pt its density and colours, dist its distance, T_in
// the transmittance entering the chunk, g the cotangent and, for a white
// background, its sum): the cotangents of the rgb head's pre-sigmoid
// outputs (drgb) and of the density head's pre-activation output (ddens),
// both published by the caller's next barrier.  S_carry is the
// suffix sum of q w over the later chunks.  MIP: the widened sigmoid's
// derivative, from the colour c the stash holds.
template <bool MIP>
__device__ __forceinline__ void composite_backward(const KParams& P, const Wgs& w, float4 pt,
                                                   float dist, float T_in, const float (&g)[4],
                                                   float& S_carry) {
  const float x = pt.x * dist;
  float incl = -x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (w.lane >= off) incl += n;
  }
  if (w.lane == 31) w.red()[w.warp] = incl;
  sm90::wg_sync(w.g);
  float before = 0.0f;
  for (int k = 0; k < w.warp; ++k) before += w.red()[k];
  const float e = expf(-x);
  const float Ti = T_in * expf((before + incl) + x);
  const float wt = (1.0f - e) * Ti;
  const float qv = (pt.y * g[0] + pt.z * g[1] + pt.w * g[2]) - g[3];
  const float qw = qv * wt;
  // strict suffix sum of q w over the chunk: the samples above in the
  // warp, then the warps above, then the later chunks
  float sfx = qw;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_down_sync(0xffffffffu, sfx, off);
    if (w.lane + off < 32) sfx += n;
  }
  float above = __shfl_down_sync(0xffffffffu, sfx, 1);
  if (w.lane == 31) above = 0.0f;
  if (w.lane == 0) w.red()[4 + w.warp] = sfx;
  sm90::wg_sync(w.g);
  float later = 0.0f;
  for (int k = w.warp + 1; k < 4; ++k) later += w.red()[4 + k];
  const float total = ((w.red()[4] + w.red()[5]) + w.red()[6]) + w.red()[7];
  const float R = (above + later) + S_carry;
  const float dalpha = qv * Ti - R / (e + 1e-10f);
  const float dsigma = dalpha * dist * e;
  const float dact = P.density_softplus ? 1.0f - expf(-pt.x) : (pt.x > 0.0f ? 1.0f : 0.0f);
  w.ddens()[w.tid] = dsigma * dact;
  if constexpr (MIP) {
    const float c[3] = {pt.y, pt.z, pt.w};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float sg = __fdiv_rn(__fadd_rn(c[j], sm90::RGB_PAD), 1.0f + 2.0f * sm90::RGB_PAD);
      w.drgb()[w.tid * 3 + j] =
          __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(wt, g[j]), 1.0f + 2.0f * sm90::RGB_PAD), sg),
                    __fsub_rn(1.0f, sg));
    }
  } else {
    w.drgb()[w.tid * 3] = (wt * g[0]) * pt.y * (1.0f - pt.y);
    w.drgb()[w.tid * 3 + 1] = (wt * g[1]) * pt.z * (1.0f - pt.z);
    w.drgb()[w.tid * 3 + 2] = (wt * g[2]) * pt.w * (1.0f - pt.w);
  }
  S_carry += total;
}

// D W^T for packed layer li into acc (64 x NT NSL, f32): the layer's ring
// slots in order, D (its output cotangent) K-major in the buffer at dbuf, W^T
// MN-major in the slot (piece p, at p kc 128 bytes, holds output columns
// [64 p, 64 p + 64)).  NSL slices of width NT cover the pieces.
template <int NT, int NSL>
__device__ __forceinline__ void bwd_product(float (&acc)[NSL][NT / 2], const Walk& wk, int li,
                                            const Wgs& w, uint32_t dbuf, const sm90::Ring& r,
                                            uint32_t& q) {
  sm90::wgmma_fence();
  const int first = wk.first[li], count = wk.count[li];
  for (int t = 0; t < count; ++t) {
    const WStage& st = wk.slot[first + t];
    sm90::wait_full(r, q);
    const uint32_t b0 = r.base + (q % r.stages) * r.stage_bytes;
    const uint32_t lbo = st.kc * 128;
    for (int ks = 0; ks < st.kc / 16; ++ks) {
      const int col = st.k0 + 16 * ks;
      const uint64_t da = sm90::desc_sw128(blk(w, dbuf, col >> 6) + (col & 63) * 2);
      const uint64_t db = sm90::desc_sw128_mn(b0 + ks * 2048, lbo);
#pragma unroll
      for (int s = 0; s < NSL; ++s)
        sm90::Wgmma<NT, 0, 1>::mma(acc[s], da, db + (uint64_t)((s * lbo) >> 4), (t | ks) != 0);
    }
    sm90::wgmma_commit();
    if (t > 0) {
      sm90::wgmma_wait<1>();
      sm90::release(r, q - 1, w.lane);
    }
    ++q;
  }
  sm90::wgmma_wait<0>();
  sm90::release(r, q - 1, w.lane);
}

// The buffer at buf holds the next layer's input A on entry: its first
// NT NSL columns become (acc where A > 0, else 0), rounded to bf16, in
// place.  The mask is read with ldmatrix from the same lane addresses the
// stmatrix writes, so it arrives in the accumulators' layout.  Columns past
// the layer's width multiplied the tile image's zero rows: they get 0.
// Every accumulator is read on every path (a read under a condition makes
// ptxas serialize the wgmmas).  LIN: where ``mask`` is false the values go
// in unmasked (the mip arch's linear bottleneck), selected without a branch.
template <int NT, int NSL, bool LIN = false>
__device__ __forceinline__ void epi_mask(const float (&acc)[NSL][NT / 2], uint32_t buf,
                                         const Wgs& w, bool mask = true) {
  // LIN: a mask word of all ones (two bf16 ones) where the mask is off
  const uint32_t keep = mask ? 0u : 0x3f803f80u;
  const int tile = w.lane >> 3;
  const int row = 16 * w.warp + (w.lane & 7) + 8 * (tile & 1);
  const uint32_t row_addr = buf + row * 128;
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
#pragma unroll
    for (int j = 0; j < NT / 8; j += 2) {
      const int chunk = s * NT / 8 + j + (tile >> 1);   // 16-byte column chunk
      const uint32_t addr = row_addr + (chunk >> 3) * KB_BYTES + (((chunk & 7) ^ (row & 7)) << 4);
      uint32_t m0, m1, m2, m3;
      sm90::ldmatrix_x4(addr, m0, m1, m2, m3);
      if constexpr (LIN) {
        m0 = mask ? m0 : keep;
        m1 = mask ? m1 : keep;
        m2 = mask ? m2 : keep;
        m3 = mask ? m3 : keep;
      }
      sm90::stmatrix_x4(addr, masked(acc[s][4 * j], acc[s][4 * j + 1], m0),
                        masked(acc[s][4 * j + 2], acc[s][4 * j + 3], m1),
                        masked(acc[s][4 * j + 4], acc[s][4 * j + 5], m2),
                        masked(acc[s][4 * j + 6], acc[s][4 * j + 7], m3));
    }
  }
}

// two floats of device memory, read or written by the threads whose ``on``
// is set (predicated inside the asm: no divergent branch, which would make
// ptxas serialize the wgmmas)
__device__ __forceinline__ float2 ld_f2(const float* p, bool on) {
  float x = 0.0f, y = 0.0f;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p ld.global.v2.f32 {%0, %1}, [%2];\n}\n"
               : "+f"(x), "+f"(y)
               : "l"(p), "r"((int)on));
  return make_float2(x, y);
}

__device__ __forceinline__ void st_f2(float* p, float2 v, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p st.global.v2.f32 [%0], {%1, %2};\n}\n"
               ::"l"(p), "f"(v.x), "f"(v.y), "r"((int)on)
               : "memory");
}

// gB[c] += the sum over the record's 64 rows of D[:, c], c < n, from the
// buffer's bf16 values, in f32, rows in order, thread t columns 2t, 2t + 1
// (+ 256); for rgb1 (its 128 columns: the first pair of threads below 64)
// ddir too.  Every thread runs every pass; those past n store nothing.
__device__ __forceinline__ void column_sums(const Wgs& w, uint32_t buf, int n,
                                            float* __restrict__ gB, bool rgb1, float2& ddir) {
  for (int c0 = 0; c0 < n; c0 += 256) {
    const int c = c0 + 2 * w.tid;
    const bool on = c < n;
    const float2 old = ld_f2(gB + c, on);   // in flight while the rows are summed
    const uint32_t b = blk(w, buf, c >> 6);
    float sx = 0.0f, sy = 0.0f;
#pragma unroll 8
    for (int r = 0; r < 64; ++r) {
      const uint32_t v = lds32(b + in_block(r, c & 63));
      sx += __uint_as_float(v << 16);
      sy += __uint_as_float(v & 0xffff0000u);
    }
    st_f2(gB + c, make_float2(old.x + sx, old.y + sy), on);
    const bool dir = rgb1 && on;
    ddir.x = dir ? ddir.x + sx : ddir.x;
    ddir.y = dir ? ddir.y + sy : ddir.y;
  }
}

// the rgb head's output cotangent D (64 x 16): columns 0..2 the record's
// drgb rounded to bf16, then zeros (thread t: row t / 2, 16-byte chunk t % 2)
__device__ __forceinline__ void rgb2_cotangent(const Wgs& w, uint32_t buf, const float* drgb) {
  const int row = w.tid >> 1, half = w.tid & 1;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (half == 0) {
    v.x = bf16x2(drgb[row * 3], drgb[row * 3 + 1]);
    v.y = bf16x2(drgb[row * 3 + 2], 0.0f);
  }
  sts128(buf + in_block(row, 8 * half), v);
}

// the density/feature head's cotangent columns [h, h + 16) (h a multiple of
// 16): the density column's, ddens rounded to bf16, then zeros
__device__ __forceinline__ void head_cotangent(const Wgs& w, uint32_t buf, int h,
                                               const float* ddens) {
  const int row = w.tid >> 1, col = h + 8 * (w.tid & 1);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if ((w.tid & 1) == 0) v.x = bf16x2(ddens[row], 0.0f);
  sts128(blk(w, buf, col >> 6) + in_block(row, col & 63), v);
}

// A warpgroup's walk: its rays' records in the order they are walked, the
// ring, the buffer it is on (u) and the mask barriers' phases.
struct Walker {
  const KParams& P;
  const Walk& wk;
  const RevArgs& a;
  const Wgs& w;
  const sm90::Ring& r;
  float* gB;
  uint32_t q, ph;
  int u, total, step, first;
  bool lead;

  // the i-th record this warpgroup walks: its rays' chunks from the last,
  // each chunk's second record first
  __device__ __forceinline__ size_t record(int i) const {
    const int nrec = 2 * a.n_chunks;
    const int slot = i / nrec, k = i - slot * nrec;
    const int ray = slot * step + first + w.g;
    return (size_t)ray * nrec + 2 * (a.n_chunks - 1 - (k >> 1)) + 1 - (k & 1);
  }

  // the output of packed layer j (the input of layer j + 1) of record rec
  // into buffer b, by bulk copy (the lead thread)
  __device__ __forceinline__ void load_input(int b, size_t rec, int j) const {
    const int width = P.layers[j].kind == nerf::K_RGB1 ? nerf::RGB1_N : P.hidden;
    const int bytes = (width + 63) / 64 * KB_BYTES;
    if (lead) {
      sm90::fence_proxy_async();
      sm90::mbar_expect_tx(w.full + 8 * b, bytes);
      sm90::bulk_copy(w.buf + b * BUF_BYTES,
                      a.stash_act + rec * wk.rec_act + (size_t)(wk.enc_kb + j * wk.act_kb) * IMG_BLOCK,
                      bytes, w.full + 8 * b);
    }
  }

  // After layer li's product (acc): the buffer of its D is free once its
  // store has read it; it takes the input two layers down (or the next
  // record's first), and the other buffer, which holds layer li - 1's
  // output, becomes that layer's output cotangent.
  template <int NT, int NSL, bool MIP>
  __device__ __forceinline__ void next_cotangent(const float (&acc)[NSL][NT / 2], int li,
                                                 size_t rec, int i, const float* ddens) {
    sm90::bulk_wait_read(lead);
    sm90::wg_sync(w.g);
    if (li >= 2)
      load_input(u, rec, li - 2);
    else if (i + 1 < total)
      load_input(u, record(i + 1), P.n_layers - 2);
    const int o = u ^ 1;
    sm90::mbar_wait(w.full + 8 * o, (ph >> o) & 1);
    ph ^= 1u << o;
    // MIP: the bottleneck (the density/feature head's output) is linear
    epi_mask<NT, NSL, MIP>(acc, w.buf + o * BUF_BYTES, w,
                           !(MIP && P.layers[li - 1].kind == nerf::K_DENSFEAT));
    if (P.layers[li - 1].kind == nerf::K_DENSFEAT) {
      sm90::wg_sync(w.g);   // the epilogue's zeros past the width come first
      head_cotangent(w, w.buf + o * BUF_BYTES, P.hidden, ddens);
    }
    sm90::fence_proxy_async();
    sm90::wg_sync(w.g);
    u = o;
  }

  // The MLP backward of record rec (the i-th walked, half hf of its chunk,
  // whose compositing cotangents are in drgb and ddens): every layer's
  // output cotangent to the cotangent stash, its bias grad to gB.
  template <int NT, int NSL, bool MIP>
  __device__ __forceinline__ void walk_record(size_t rec, int hf, int i, float2& ddir) {
    const int nl = P.n_layers;
    sm90::bulk_wait_read(lead);   // the previous record's last store has read buf[u]
    sm90::wg_sync(w.g);
    rgb2_cotangent(w, w.buf + u * BUF_BYTES, w.drgb() + 64 * hf * 3);
    sm90::fence_proxy_async();
    sm90::wg_sync(w.g);
    for (int li = nl - 1;; --li) {
      const nerf::LayerDesc& L = P.layers[li];
      const int nblk = (L.N + 63) / 64;
      __nv_bfloat16* cot = a.stash_cot + rec * wk.rec_cot + (size_t)wk.cot_off[li] * IMG_BLOCK;
      const uint32_t dbuf = w.buf + u * BUF_BYTES;
      sm90::bulk_store(cot, dbuf, (nblk < BUF_BLOCKS ? nblk : BUF_BLOCKS) * KB_BYTES, lead);
      if (nblk > BUF_BLOCKS) sm90::bulk_store(cot + BUF_BLOCKS * IMG_BLOCK, w.head, KB_BYTES, lead);
      column_sums(w, dbuf, L.N, gB + L.b_off, L.kind == nerf::K_RGB1, ddir);
      if (li == 0) break;
      if (li == nl - 1) {
        float acc[1][64];
        bwd_product<128, 1>(acc, wk, li, w, dbuf, r, q);
        next_cotangent<128, 1, MIP>(acc, li, rec, i, w.ddens() + 64 * hf);
      } else {
        float acc[NSL][NT / 2];
        bwd_product<NT, NSL>(acc, wk, li, w, dbuf, r, q);
        next_cotangent<NT, NSL, MIP>(acc, li, rec, i, w.ddens() + 64 * hf);
      }
    }
  }

  // a warpgroup with no ray left still releases every slot of a record
  __device__ __forceinline__ void skip_record() {
    for (int t = 0; t < wk.n_stages; ++t, ++q) {
      sm90::wait_full(r, q);
      sm90::release(r, q, w.lane);
    }
  }
};

// The producer: one lane streams the walk's slots `rounds` times, each slot
// its pieces side by side.
__device__ __forceinline__ void produce(const Walk& wk, const __nv_bfloat16* __restrict__ img,
                                        const sm90::Ring& r, int rounds) {
  uint32_t q = 0;
  for (int k = 0; k < rounds; ++k) {
    for (int t = 0; t < wk.n_stages; ++t, ++q) {
      const WStage& st = wk.slot[t];
      const uint32_t slot = q % r.stages;
      sm90::mbar_wait(r.empty + 8 * slot, ((q / r.stages) & 1) ^ 1);
      const int bytes = st.kc * 128;
      sm90::mbar_expect_tx(r.full + 8 * slot, st.pieces * bytes);
      for (int p = 0; p < st.pieces; ++p)
        sm90::bulk_copy(r.base + slot * r.stage_bytes + p * bytes, img + st.off + p * st.stride,
                        bytes, r.full + 8 * slot);
    }
  }
}

// NT x NSL: the hidden width's 64-column pieces as wgmma slices (wk.nb of them)
template <int NT, int NSL, bool MIP>
__global__ void __launch_bounds__(sm90::THREADS, 1)
reverse_walk_kernel(const __nv_bfloat16* __restrict__ img, const __grid_constant__ KParams P,
                    const __grid_constant__ Walk wk, const __grid_constant__ RevArgs a) {
  extern __shared__ __align__(128) char smem_raw[];
  char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  sm90::Ring ring;
  ring.base = sm90::smem_addr(base + wk.ring);
  ring.full = sm90::smem_addr(base + wk.bars);
  ring.empty = ring.full + 8 * sm90::MAX_STAGES;
  ring.stages = wk.stages;
  ring.stage_bytes = wk.stage_bytes;
  // cotangent buffer b of warpgroup g: its barrier at mask_bars + 8 (2 g + b)
  const uint32_t mask_bars = ring.full + 16 * sm90::MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < wk.stages; ++i) {
      sm90::mbar_init(ring.full + 8 * i, 1);
      sm90::mbar_init(ring.empty + 8 * i, sm90::EMPTY_ARRIVALS);
    }
    for (int i = 0; i < 2 * sm90::CONSUMERS; ++i) sm90::mbar_init(mask_bars + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int nrec = 2 * a.n_chunks;
  const int step = sm90::CONSUMERS * gridDim.x;
  const int first = sm90::CONSUMERS * blockIdx.x;
  // ray slots of warpgroup 0 (warpgroup 1 has as many or one fewer)
  const int slots = first < a.n_rays ? (a.n_rays - first + step - 1) / step : 0;
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (g == sm90::CONSUMERS) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == sm90::CONSUMERS * 128) produce(wk, img, ring, slots * nrec);
    return;
  }
  sm90::regs_alloc<232>();
  Wgs w;
  w.g = g;
  w.tid = threadIdx.x & 127;
  w.warp = w.tid >> 5;
  w.lane = w.tid & 31;
  w.buf = sm90::smem_addr(base + wk.buf + 2 * g * BUF_BYTES);
  w.full = mask_bars + 16 * g;
  w.head = sm90::smem_addr(base + wk.head + g * KB_BYTES);
  w.small = reinterpret_cast<float*>(base + wk.small) + g * WG_FLOATS;

  float* part = a.partials + (size_t)(blockIdx.x * sm90::CONSUMERS + g) * a.grad_stride;
  Walker wr{P, wk, a, w, ring, part + P.dir_dim * nerf::RGB1_N, 0u, 0u, 0, 0, step, first,
            w.tid == 0};
  const int mine = first + g < a.n_rays ? (a.n_rays - first - g + step - 1) / step : 0;
  wr.total = mine * nrec;
  if (wr.total > 0) wr.load_input(1, wr.record(0), P.n_layers - 2);

  int i = 0;
  for (int slot = 0; slot < slots; ++slot) {
    const int ray = slot * step + first + g;
    if (ray >= a.n_rays) {
      for (int k = 0; k < nrec; ++k) wr.skip_record();
      continue;
    }
    // MIP: the unit view direction d / |d| under mip-NeRF's encoding
    const float norm = MIP ? a.cones[ray * 2 + 1] : 1.0f;
    const float d[3] = {MIP ? __fdiv_rn(a.dirs[ray * 3], norm) : a.dirs[ray * 3],
                        MIP ? __fdiv_rn(a.dirs[ray * 3 + 1], norm) : a.dirs[ray * 3 + 1],
                        MIP ? __fdiv_rn(a.dirs[ray * 3 + 2], norm) : a.dirs[ray * 3 + 2]};
    if (w.tid < P.dir_dim)
      w.dext()[w.tid] = nerf::bf16_round(
          MIP ? nerf::encode_view_mip(d, w.tid, P.dir_dim, P.dir_freq, P.half_pi)
              : nerf::encode(d, w.tid, P.dir_dim, P.dir_freq, P.half_pi));
    float gv[4];
#pragma unroll
    for (int j = 0; j < 3; ++j)   // the caller's cotangent, or the MSE's from the sweep's rgb
      gv[j] = a.g_in ? a.g_in[ray * 3 + j] : (a.rgb[ray * 3 + j] - a.target[ray * 3 + j]) * a.gscale;
    gv[3] = P.white_bg ? (gv[0] + gv[1]) + gv[2] : 0.0f;
    float2 ddir = make_float2(0.0f, 0.0f);
    float S_carry = 0.0f;
    const float* z_ray = a.z + (size_t)ray * (MIP ? a.n_sample + 1 : a.n_sample);
    for (int c = a.n_chunks - 1; c >= 0; --c) {
      const size_t q0 = (size_t)ray * nrec + 2 * c;
      const int si = c * 128 + w.tid;
      float dist;
      if constexpr (MIP)
        dist = si >= a.n_sample ? 0.0f : __fmul_rn(__fsub_rn(z_ray[si + 1], z_ray[si]), norm);
      else
        dist = si >= a.n_sample       ? 0.0f
               : si < a.n_sample - 1 ? z_ray[si + 1] - z_ray[si]
                                     : P.tail;
      composite_backward<MIP>(P, w, a.stash_pt[q0 * 64 + w.tid], dist,
                              a.tb[(size_t)ray * a.n_chunks + c], gv, S_carry);
      for (int hf = 1; hf >= 0; --hf, ++i) wr.walk_record<NT, NSL, MIP>(q0 + hf, hf, i, ddir);
    }
    // rgb1's direction rows, once per ray: dext^T ddir, plain f32 FMAs
    if (w.tid < 64) {
      w.ddir()[2 * w.tid] = ddir.x;
      w.ddir()[2 * w.tid + 1] = ddir.y;
    }
    sm90::wg_sync(g);
    for (int k = 0; k < P.dir_dim; ++k) {
      float* e = part + k * nerf::RGB1_N + w.tid;
      *e = fmaf(w.dext()[k], w.ddir()[w.tid], *e);
    }
    sm90::wg_sync(g);
  }
  sm90::bulk_wait_all(w.tid == 0);
}

// dst += the sum over blocks, in index order, of partials[b][i]: element
// i < n_a to dst_a[i], the rest to dst_b[i - n_a] (the split step adds each
// ray group's partials to the grads in group order)
__global__ void reduce_add_kernel(const float* __restrict__ partials, int n_blocks, int stride,
                                  int n_a, float* dst_a, float* dst_b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float sum = 0.0f;
  for (int b = 0; b < n_blocks; ++b) sum += partials[(size_t)b * stride + i];
  float* dst = i < n_a ? dst_a + i : dst_b + (i - n_a);
  *dst += sum;
}

template <int NT, int NSL, bool MIP>
cudaError_t launch_walk(const __nv_bfloat16* img, const KParams& P, const Walk& wk,
                        const RevArgs& a, int n_blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(reverse_walk_kernel<NT, NSL, MIP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, wk.total);
  if (err != cudaSuccess) return err;
  reverse_walk_kernel<NT, NSL, MIP><<<n_blocks, sm90::THREADS, wk.total, stream>>>(img, P, wk, a);
  return cudaGetLastError();
}

template <bool MIP>
cudaError_t walk(const __nv_bfloat16* img, const KParams& P, const Walk& wk, const RevArgs& a,
                 int n_blocks, cudaStream_t s) {
  switch (wk.nb) {   // the hidden width in 64-column pieces
    case 1: return launch_walk<64, 1, MIP>(img, P, wk, a, n_blocks, s);
    case 2: return launch_walk<128, 1, MIP>(img, P, wk, a, n_blocks, s);
    case 3: return launch_walk<64, 3, MIP>(img, P, wk, a, n_blocks, s);
    default: return launch_walk<256, 1, MIP>(img, P, wk, a, n_blocks, s);
  }
}

}  // namespace

extern "C" {

// The reverse walk of one ray group.  The cotangent is g_in (n_rays, 3) when
// it is not null, else (rgb - target) * gscale.  weights: the render tile
// image (kernels/fused_render.py:render_tile_image).  iparams and fparams:
// see parse_params in nerf_device.cuh.  The caller allocates everything:
// cones: (n_rays, 2) radius and |d| for the mip arch (z then holds
// n_sample + 1 edges a ray), else null.
//   tb        (n_rays, n_chunks) f32 and stash_act, stash_pt: the forward
//             sweep's (layout: kernels/fused_train.py:_walk_ints, the
//             stash layout then the walk's ring slots);
//   stash_cot (n_rays, 2 n_chunks, rec_cot) bf16, written;
//   partials  (2 n_blocks, grad_stride) f32, ZEROED, grad_stride = dir_dim *
//             128 + the bias buffer's length (sfm_reduce_add sums them).
// n_blocks must not exceed ceil(n_rays / 2); one block runs per SM.
// Returns 0 or a cudaError_t.
int sfm_reverse_walk(const float* dirs, const float* z, const float* cones, const float* rgb,
                     const float* target,
                     const float* g_in, float gscale, int n_rays, int n_sample,
                     const void* weights, const int* iparams, const float* fparams,
                     const float* tb, const void* stash_act, const float* stash_pt,
                     void* stash_cot, const int* layout, float* partials, int n_blocks,
                     int grad_stride, void* stream) {
  KParams P;
  cudaError_t err = nerf::parse_params(iparams, fparams, &P);
  if (err != cudaSuccess) return err;
  if (n_rays <= 0) return cudaSuccess;
  if (n_blocks < 1 || n_blocks > (n_rays + 1) / 2 || P.hidden > 256 || P.hidden % 16 ||
      !layout || (!g_in && (!rgb || !target)) || (P.mip && !cones))
    return cudaErrorInvalidValue;
  Walk wk;
  if ((err = parse_walk(P, layout, &wk)) != cudaSuccess) return err;
  RevArgs a{};
  a.dirs = dirs;
  a.z = z;
  a.cones = cones;
  a.tb = tb;
  a.rgb = rgb;
  a.target = target;
  a.g_in = g_in;
  a.stash_act = static_cast<const __nv_bfloat16*>(stash_act);
  a.stash_pt = reinterpret_cast<const float4*>(stash_pt);
  a.stash_cot = static_cast<__nv_bfloat16*>(stash_cot);
  a.partials = partials;
  a.n_rays = n_rays;
  a.n_sample = n_sample;
  a.n_chunks = (n_sample + 127) / 128;
  a.grad_stride = grad_stride;
  a.gscale = gscale;
  const auto* img = static_cast<const __nv_bfloat16*>(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return P.mip ? walk<true>(img, P, wk, a, n_blocks, s) : walk<false>(img, P, wk, a, n_blocks, s);
}

// dst += the sum over n_blocks partial rows of length stride, in block
// order: element i < n_a to dst_a[i], the rest to dst_b[i - n_a].
int sfm_reduce_add(const float* partials, int n_blocks, int stride, int n_a, float* dst_a,
                   float* dst_b, void* stream) {
  if (n_blocks < 1 || stride < 1) return cudaErrorInvalidValue;
  reduce_add_kernel<<<(stride + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_blocks, stride, n_a, dst_a, dst_b);
  return cudaGetLastError();
}

const char* sfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
