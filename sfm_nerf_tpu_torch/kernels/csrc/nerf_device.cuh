// Device code shared by the fused NeRF kernels: the kernel parameters
// (KParams, parse_params) and the positional encoding (encode), which the
// render kernel (fused_render.cu) and the reverse walk (fused_train.cu)
// both read.
//
// Numerics kept from the TPU kernels (correctness rules, not TPU devices):
// - encoding phase in exact f32 (separate rounded multiply and add, no
//   contraction), accurate sinf (never __sinf; no --use_fast_math);
// - bf16 rounding of the encoding where the TPU kernel rounds it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf {

constexpr int MAX_LAYERS = 16;
constexpr int MAX_FREQ = 16;
constexpr int RGB1_N = 128;

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

}  // namespace nerf
