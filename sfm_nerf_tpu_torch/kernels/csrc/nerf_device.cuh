// Device code shared by the fused NeRF kernels (fused_render.cu: render;
// fused_train.cu: training step): the kernel parameters, the shared-memory
// layout, the positional encoding, the weight-slab pipeline, one layer of
// the MLP on the tensor cores, and the forward of one chunk of 128 sample
// points with its compositing.
//
// Blocking: a block takes one ray at a time and walks its samples in
// chunks of M = 128 points, one point per row.  Warp w owns rows
// [16w, 16w+16) of every activation buffer, so forward activations never
// cross warps; only the weight slab is shared.  All activations of a chunk
// stay in shared memory as bf16; the products run on the tensor cores (WMMA
// bf16 x bf16 -> f32) with the weights streamed through a double-buffered
// shared-memory slab (cp.async).
//
// Numerics kept from the TPU kernels (correctness rules, not TPU devices):
// - encoding phase in exact f32 (separate rounded multiply and add, no
//   contraction), accurate sinf (never __sinf; no --use_fast_math);
// - 1 - alpha as expf(-x); the exclusive transmittance as expf(csum + x);
// - samples past the ray's last get a zero distance: they add exactly 0;
// - bf16 rounding of the encoding and of the hidden activations where the
//   TPU kernel rounds them; biases, the density and rgb heads in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace nerf {

using namespace nvcuda;

constexpr int M = 128;              // sample points per chunk (rows)
constexpr int WARPS = 8;            // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int KS = 32;              // weight rows per forward slab
constexpr int NB = 128;             // output columns per pass
constexpr int SLAB_LD = NB + 8;
constexpr int KT = 128;             // weight rows per transposed slab (backward)
constexpr int NT = 32;              // weight columns per transposed slab
constexpr int SLABT_LD = NT + 8;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_FREQ = 16;
constexpr int RGB1_N = 128;
constexpr int N_SIZES = 16;

enum Kind { K_FC1 = 0, K_PLAIN = 1, K_SKIP = 2, K_DENSFEAT = 3, K_RGB1 = 4, K_RGB2 = 5 };

struct LayerDesc {
  int kind, w_off, b_off, K, N;
};

struct KParams {
  LayerDesc layers[MAX_LAYERS];
  int n_layers, hidden, pos_dim, pos_pad, dir_dim;
  int density_softplus, variant_train, white_bg;
  float tail, half_pi;
  float pos_freq[MAX_FREQ], dir_freq[MAX_FREQ];
};

struct Smem {
  __nv_bfloat16 *act0, *act1, *ext, *slab0, *slab1;
  float *scratch, *pts, *dist, *dens, *rgb, *dirpart, *dext;
  float *drgb, *ddens, *ddir, *g;   // training layout only
  int act_ld, ext_ld;
};

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) & ~127; }

// One layout, computed alike on the host (size) and in the kernel (carve).
// The training layout widens the activation rows by 16 columns (the
// density/feature head's cotangent is hidden + 16 wide), sizes the slabs
// for the transposed weight tiles too, and adds the backward's small
// arrays.
__host__ __device__ inline int smem_layout(const KParams& P, char* base, Smem* s, bool train) {
  const int wide = P.hidden > RGB1_N ? P.hidden : RGB1_N;
  const int act_ld = wide + (train ? 16 : 0) + 8;
  const int ext_ld = P.pos_pad + 8;
  const int slab = (train && KT * SLABT_LD > KS * SLAB_LD) ? KT * SLABT_LD : KS * SLAB_LD;
  const int sizes[N_SIZES] = {
      M * act_ld * 2, M * act_ld * 2, M * ext_ld * 2,
      slab * 2, slab * 2,
      WARPS * 256 * 4, M * 3 * 4, M * 4, M * 4, M * 3 * 4, RGB1_N * 4,
      3 * (2 * MAX_FREQ + 1) * 4 + 4,
      train ? M * 3 * 4 : 0, train ? M * 4 : 0, train ? RGB1_N * 4 : 0, train ? 16 : 0,
  };
  int off = 0, offs[N_SIZES];
  for (int i = 0; i < N_SIZES; ++i) {
    offs[i] = off;
    off += align128(sizes[i]);
  }
  if (s) {
    char* p[N_SIZES];
    for (int i = 0; i < N_SIZES; ++i) p[i] = base + offs[i];
    s->act0 = reinterpret_cast<__nv_bfloat16*>(p[0]);
    s->act1 = reinterpret_cast<__nv_bfloat16*>(p[1]);
    s->ext = reinterpret_cast<__nv_bfloat16*>(p[2]);
    s->slab0 = reinterpret_cast<__nv_bfloat16*>(p[3]);
    s->slab1 = reinterpret_cast<__nv_bfloat16*>(p[4]);
    s->scratch = reinterpret_cast<float*>(p[5]);
    s->pts = reinterpret_cast<float*>(p[6]);
    s->dist = reinterpret_cast<float*>(p[7]);
    s->dens = reinterpret_cast<float*>(p[8]);
    s->rgb = reinterpret_cast<float*>(p[9]);
    s->dirpart = reinterpret_cast<float*>(p[10]);
    s->dext = reinterpret_cast<float*>(p[11]);
    s->drgb = reinterpret_cast<float*>(p[12]);
    s->ddens = reinterpret_cast<float*>(p[13]);
    s->ddir = reinterpret_cast<float*>(p[14]);
    s->g = reinterpret_cast<float*>(p[15]);
    s->act_ld = act_ld;
    s->ext_ld = ext_ld;
  }
  return off;
}

// iparams: n_layers, hidden, pos_dim, pos_pad, dir_dim, density_softplus,
//          variant_train, white_bg, then (kind, w_off, b_off, K, N) per layer.
// fparams: tail, half_pi, pos_freq[16], dir_freq[16] (pi * 2^l, zero-padded).
inline cudaError_t parse_params(const int* iparams, const float* fparams, KParams* P) {
  P->n_layers = iparams[0];
  if (P->n_layers < 4 || P->n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  P->hidden = iparams[1];
  P->pos_dim = iparams[2];
  P->pos_pad = iparams[3];
  P->dir_dim = iparams[4];
  P->density_softplus = iparams[5];
  P->variant_train = iparams[6];
  P->white_bg = iparams[7];
  if (P->pos_dim > 3 * (2 * MAX_FREQ + 1) || P->dir_dim > 3 * (2 * MAX_FREQ + 1))
    return cudaErrorInvalidValue;
  for (int i = 0; i < P->n_layers; ++i) {
    const int* q = iparams + 8 + 5 * i;
    P->layers[i] = LayerDesc{q[0], q[1], q[2], q[3], q[4]};
  }
  P->tail = fparams[0];
  P->half_pi = fparams[1];
  for (int i = 0; i < MAX_FREQ; ++i) {
    P->pos_freq[i] = fparams[2 + i];
    P->dir_freq[i] = fparams[2 + MAX_FREQ + i];
  }
  return cudaSuccess;
}

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// column c of [x ++ sin/cos(pi 2^l x) ++ 0-pad]: exact f32 phase (rounded
// product, rounded phase shift), accurate sinf
__device__ inline float encode(const float* x, int c, int n_dim,
                               const float* freq, float half_pi) {
  if (c < 3) return x[c];
  if (c >= n_dim) return 0.0f;
  const int t = c - 3, l = t / 6, r = t % 6;
  float u = __fmul_rn(x[r % 3], freq[l]);
  if (r >= 3) u = __fadd_rn(u, half_pi);
  return sinf(u);
}

// copy weight rows [r0, r0+nr) x columns [c0, c0+nc) into a shared tile of
// row stride ld (cp.async, one commit group)
__device__ inline void load_tile(__nv_bfloat16* tile, int ld, const __nv_bfloat16* W,
                                 int ldw, int r0, int nr, int c0, int nc) {
  const int vec_per_row = nc / 8;
  for (int i = threadIdx.x; i < nr * vec_per_row; i += THREADS) {
    const int r = i / vec_per_row, v = i - r * vec_per_row;
    __pipeline_memcpy_async(tile + r * ld + v * 8,
                            W + (size_t)(r0 + r) * ldw + c0 + v * 8, 16);
  }
  __pipeline_commit();
}

__device__ inline void load_slab(__nv_bfloat16* slab, const __nv_bfloat16* W,
                                 int ldw, int k0, int ks, int n0, int nb) {
  load_tile(slab, SLAB_LD, W, ldw, k0, ks, n0, nb);
}

// out = act(in[:, :K] @ W + b) for this block's 128 rows.  Rows k < k_main
// of the product read ``in``, rows k >= k_main read ``ext`` (the skip
// layer's concat, without building it).  The epilogue depends on the kind.
__device__ inline void run_layer(const KParams& P, const LayerDesc& L,
                                 const __nv_bfloat16* __restrict__ W,
                                 const float* __restrict__ B, const Smem& s,
                                 const __nv_bfloat16* in, int in_ld, int k_main,
                                 __nv_bfloat16* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const __nv_bfloat16* Wl = W + L.w_off;
  const float* Bl = B + L.b_off;
  float* scratch = s.scratch + warp * 256;
  const int n_pass = (L.N + NB - 1) / NB;
  const int n_ks = (L.K + KS - 1) / KS;
  const int total = n_pass * n_ks;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB / 16];

  load_slab(s.slab0, Wl, L.N, 0, min(KS, L.K), 0, min(NB, L.N));
  for (int it = 0; it < total; ++it) {
    const int pass = it / n_ks, ki = it - pass * n_ks;
    const int n0 = pass * NB, nb = min(NB, L.N - n0), nfr = nb / 16;
    const int k0 = ki * KS, ks = min(KS, L.K - k0);
    __nv_bfloat16* slab = (it & 1) ? s.slab1 : s.slab0;
    if (it + 1 < total) {
      const int pn = (it + 1) / n_ks, pk = (it + 1) - pn * n_ks;
      load_slab((it & 1) ? s.slab0 : s.slab1, Wl, L.N, pk * KS,
                min(KS, L.K - pk * KS), pn * NB, min(NB, L.N - pn * NB));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (ki == 0) {
#pragma unroll
      for (int f = 0; f < NB / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
    }
    for (int kk = 0; kk < ks; kk += 16) {
      const int k = k0 + kk;
      const __nv_bfloat16* a_ptr =
          k < k_main ? in + row0 * in_ld + k : s.ext + row0 * s.ext_ld + (k - k_main);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_ptr, k < k_main ? in_ld : s.ext_ld);
#pragma unroll
      for (int f = 0; f < NB / 16; ++f) {
        if (f < nfr) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, slab + kk * SLAB_LD + f * 16, SLAB_LD);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    if (ki == n_ks - 1) {
      // epilogue: warp-private rows, through a 16x16 f32 scratch tile
#pragma unroll
      for (int f = 0; f < NB / 16; ++f) {
        if (f < nfr) {
          __syncwarp();
          wmma::store_matrix_sync(scratch, acc[f], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int row = row0 + (e >> 4), col = n0 + f * 16 + (e & 15);
            const float v = scratch[e];
            switch (L.kind) {
              case K_DENSFEAT:
                if (col < P.hidden) {
                  out[row * s.act_ld + col] = __float2bfloat16_rn(fmaxf(v + Bl[col], 0.0f));
                } else if (col == P.hidden) {
                  const float x = v + Bl[col];
                  s.dens[row] = P.density_softplus
                                    ? fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))
                                    : fmaxf(x, 0.0f);
                }
                break;
              case K_RGB1:
                out[row * s.act_ld + col] =
                    __float2bfloat16_rn(fmaxf((v + s.dirpart[col]) + Bl[col], 0.0f));
                break;
              case K_RGB2:
                if (col < 3) s.rgb[row * 3 + col] = 1.0f / (1.0f + expf(-(v + Bl[col])));
                break;
              default:
                out[row * s.act_ld + col] = __float2bfloat16_rn(fmaxf(v + Bl[col], 0.0f));
            }
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// Per ray: the encoded direction (rounded to bf16) and the direction head,
// bf16(encoded d) @ rgb1's direction rows, evaluated once.
__device__ inline void setup_ray(const KParams& P, const __nv_bfloat16* __restrict__ W,
                                 const Smem& s, const float* d) {
  const int tid = threadIdx.x;
  const LayerDesc& rgb1 = P.layers[P.n_layers - 2];
  if (tid < P.dir_dim)
    s.dext[tid] = bf16_round(encode(d, tid, P.dir_dim, P.dir_freq, P.half_pi));
  __syncthreads();
  if (tid < RGB1_N) {
    const __nv_bfloat16* wd = W + rgb1.w_off + (size_t)P.hidden * RGB1_N + tid;
    float acc = 0.0f;
    for (int k = 0; k < P.dir_dim; ++k)
      acc = fmaf(s.dext[k], __bfloat162float(wd[k * RGB1_N]), acc);
    s.dirpart[tid] = acc;
  }
}

// Points, distances and the position encoding of samples [c0, c0 + M) of a
// ray.  The first __syncthreads of the layer that follows publishes ext.
__device__ inline void prepare_chunk(const KParams& P, const Smem& s, const float* o,
                                     const float* d, const float* __restrict__ z_ray,
                                     int S, int c0) {
  const int tid = threadIdx.x;
  if (tid < M) {
    const int si = c0 + tid;
    const int sc = si < S ? si : S - 1;
    const float zs = z_ray[sc];
#pragma unroll
    for (int j = 0; j < 3; ++j) s.pts[tid * 3 + j] = __fadd_rn(o[j], __fmul_rn(d[j], zs));
    s.dist[tid] = si >= S ? 0.0f : si < S - 1 ? z_ray[si + 1] - zs : P.tail;
  }
  __syncthreads();
  for (int e = tid; e < M * P.pos_pad; e += THREADS) {
    const int r = e / P.pos_pad, c = e - r * P.pos_pad;
    s.ext[r * s.ext_ld + c] = __float2bfloat16_rn(
        encode(s.pts + r * 3, c, P.pos_dim, P.pos_freq, P.half_pi));
  }
}

// Copy this warp's 16 rows x ncols (a multiple of 8) between a shared
// activation buffer and a dense (M, ncols_stride) bf16 array in device
// memory, 16 bytes per thread.
__device__ inline void rows_to_global(const __nv_bfloat16* buf, int ld, __nv_bfloat16* dst,
                                      int stride, int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vec = ncols / 8;
  for (int i = lane; i < 16 * vec; i += 32) {
    const int r = warp * 16 + i / vec, v = i % vec;
    *reinterpret_cast<uint4*>(dst + (size_t)r * stride + v * 8) =
        *reinterpret_cast<const uint4*>(buf + r * ld + v * 8);
  }
}

__device__ inline void rows_from_global(__nv_bfloat16* buf, int ld, const __nv_bfloat16* src,
                                        int stride, int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vec = ncols / 8;
  for (int i = lane; i < 16 * vec; i += 32) {
    const int r = warp * 16 + i / vec, v = i % vec;
    *reinterpret_cast<uint4*>(buf + r * ld + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * stride + v * 8);
  }
}

// The layer chain of one prepared chunk.  Leaves the density in s.dens and
// the colours in s.rgb (complete for all threads: run_layer ends in
// __syncthreads).  With ``stash`` each layer's output activation (all
// layers but rgb2) is also copied to device memory as layer li's dense
// (M, stash_w) bf16 block, for the backward pass.
__device__ inline void forward_chunk(const KParams& P, const __nv_bfloat16* __restrict__ W,
                                     const float* __restrict__ B, const Smem& s,
                                     __nv_bfloat16* stash, int stash_w) {
  __nv_bfloat16* cur = s.act0;
  __nv_bfloat16* other = s.act1;
  for (int li = 0; li < P.n_layers; ++li) {
    const LayerDesc& L = P.layers[li];
    switch (L.kind) {
      case K_FC1:
        run_layer(P, L, W, B, s, s.ext, s.ext_ld, L.K, cur);
        break;
      case K_SKIP:
        run_layer(P, L, W, B, s, cur, s.act_ld, P.hidden, other);
        break;
      case K_RGB2:
        run_layer(P, L, W, B, s, cur, s.act_ld, L.K, nullptr);
        break;
      default:  // plain, densfeat, rgb1
        run_layer(P, L, W, B, s, cur, s.act_ld, L.K, other);
    }
    if (L.kind != K_FC1 && L.kind != K_RGB2) {
      __nv_bfloat16* t = cur;
      cur = other;
      other = t;
    }
    if (stash && L.kind != K_RGB2)
      rows_to_global(cur, s.act_ld, stash + (size_t)li * M * stash_w, stash_w,
                     L.kind == K_RGB1 ? RGB1_N : P.hidden);
  }
}

// Warp 0 composites one chunk (call with warp 0 only, after forward_chunk):
// a warp scan of -sigma*delta, the transmittance T and the rgb sum carried
// across chunks in registers.  ``w_ray`` (or null) receives the weights.
__device__ inline void composite_chunk(const KParams& P, const Smem& s, int S, int c0,
                                       float* __restrict__ w_ray, float& T, float& acc_r,
                                       float& acc_g, float& acc_b) {
  const int lane = threadIdx.x & 31;
  float x[4], c[4];
  float run = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = lane * 4 + q;
    x[q] = s.dens[i] * s.dist[i];
    run -= x[q];
    c[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float last = __shfl_sync(0xffffffffu, incl, 31);
  float pr = 0.0f, pg = 0.0f, pb = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = lane * 4 + q;
    const float csum = excl + c[q];
    const float trans = P.variant_train ? expf(csum + x[q]) : expf(csum);
    const float w = (1.0f - expf(-x[q])) * (T * trans);
    if (w_ray && c0 + i < S) w_ray[c0 + i] = w;
    pr += w * s.rgb[i * 3];
    pg += w * s.rgb[i * 3 + 1];
    pb += w * s.rgb[i * 3 + 2];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pr += __shfl_xor_sync(0xffffffffu, pr, off);
    pg += __shfl_xor_sync(0xffffffffu, pg, off);
    pb += __shfl_xor_sync(0xffffffffu, pb, off);
  }
  acc_r += pr;
  acc_g += pg;
  acc_b += pb;
  T = T * expf(last);
}

}  // namespace nerf
