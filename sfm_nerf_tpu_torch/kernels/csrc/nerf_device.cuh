// Device code shared by the fused NeRF kernels: the kernel parameters
// (KParams, parse_params) and the positional encoding (encode), which the
// render kernel (fused_render.cu) and the reverse walk (fused_train.cu)
// both read, and the reverse walk's WMMA machinery: its shared-memory
// layout, the cp.async weight tiles it streams transposed, and the
// per-ray encoded direction.
//
// Blocking of the reverse walk: a block takes one ray at a time and walks
// its samples in chunks of M = 128 points, one point per row.  Warp w owns
// rows [16w, 16w+16) of every activation buffer; only the weight tile is
// shared.  Activations and cotangents stay in shared memory as bf16; the
// products run on the tensor cores (WMMA bf16 x bf16 -> f32) with the
// weights streamed through a double-buffered shared-memory tile
// (cp.async).
//
// Numerics kept from the TPU kernels (correctness rules, not TPU devices):
// - encoding phase in exact f32 (separate rounded multiply and add, no
//   contraction), accurate sinf (never __sinf; no --use_fast_math);
// - bf16 rounding of the encoding where the TPU kernel rounds it.

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
constexpr int KT = 128;             // weight rows per transposed slab
constexpr int NT = 32;              // weight columns per transposed slab
constexpr int SLABT_LD = NT + 8;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_FREQ = 16;
constexpr int RGB1_N = 128;
constexpr int N_SIZES = 13;

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
  __nv_bfloat16 *act0, *act1, *slab0, *slab1;
  float *scratch, *dist, *dens, *rgb, *dext, *drgb, *ddens, *ddir, *g;
  int act_ld;
};

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) & ~127; }

// The reverse walk's layout, computed alike on the host (size) and in the
// kernel (carve).  The activation rows are 16 columns wider than the
// widest layer (the density/feature head's cotangent is hidden + 16 wide).
__host__ __device__ inline int smem_layout(const KParams& P, char* base, Smem* s) {
  const int wide = P.hidden > RGB1_N ? P.hidden : RGB1_N;
  const int act_ld = wide + 16 + 8;
  const int sizes[N_SIZES] = {
      M * act_ld * 2, M * act_ld * 2, KT * SLABT_LD * 2, KT * SLABT_LD * 2,
      WARPS * 256 * 4, M * 4, M * 4, M * 3 * 4, 3 * (2 * MAX_FREQ + 1) * 4 + 4,
      M * 3 * 4, M * 4, RGB1_N * 4, 16,
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
    s->slab0 = reinterpret_cast<__nv_bfloat16*>(p[2]);
    s->slab1 = reinterpret_cast<__nv_bfloat16*>(p[3]);
    s->scratch = reinterpret_cast<float*>(p[4]);
    s->dist = reinterpret_cast<float*>(p[5]);
    s->dens = reinterpret_cast<float*>(p[6]);
    s->rgb = reinterpret_cast<float*>(p[7]);
    s->dext = reinterpret_cast<float*>(p[8]);
    s->drgb = reinterpret_cast<float*>(p[9]);
    s->ddens = reinterpret_cast<float*>(p[10]);
    s->ddir = reinterpret_cast<float*>(p[11]);
    s->g = reinterpret_cast<float*>(p[12]);
    s->act_ld = act_ld;
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

// The encoded direction of a ray, rounded to bf16, into s.dext (threads
// below dir_dim).  The caller's next __syncthreads publishes it.
__device__ inline void encode_direction(const KParams& P, const Smem& s, const float* d) {
  if (threadIdx.x < P.dir_dim)
    s.dext[threadIdx.x] = bf16_round(encode(d, threadIdx.x, P.dir_dim, P.dir_freq, P.half_pi));
}

}  // namespace nerf
