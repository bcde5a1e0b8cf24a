// Device code shared by the fused NeRF kernels: the kernel parameters
// (KParams, parse_params) and the positional encoding (encode), which the
// render kernel (fused_render.cu) and the reverse walk (fused_train.cu)
// both read; for the mip arch (KParams::mip) the conical frustum's Gaussian
// (frustum_gaussian) and mip-NeRF's view encoding (encode_view_mip).
//
// Numerics kept from the TPU kernels (correctness rules, not TPU devices):
// - encoding phase in exact f32 (separate rounded multiply and add, no
//   contraction), accurate sinf (never __sinf; no --use_fast_math);
// - bf16 rounding of the encoding where the TPU kernel rounds it;
// - the mip arch's Gaussian with every product, quotient and sum rounded
//   once (no contraction), the order of ops/encoding.py:frustum_gaussian.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf {

constexpr int MAX_LAYERS = 16;
constexpr int MAX_FREQ = 16;
constexpr int RGB1_N = 128;
constexpr int HEAD_INTS = 9;   // iparams before the layers

enum Kind { K_FC1 = 0, K_PLAIN = 1, K_SKIP = 2, K_DENSFEAT = 3, K_RGB1 = 4, K_RGB2 = 5 };

struct LayerDesc {
  int kind, w_off, b_off, K, N;
};

struct KParams {
  LayerDesc layers[MAX_LAYERS];
  int n_layers, hidden, pos_dim, pos_pad, dir_dim;
  int density_softplus, variant_train, white_bg;
  // the mip arch: cones over S + 1 edges a ray, integrated encoding, linear
  // bottleneck, widened sigmoid, compositing over interval lengths
  int mip;
  float tail, half_pi;
  float pos_freq[MAX_FREQ], dir_freq[MAX_FREQ];
};

// iparams: n_layers, hidden, pos_dim, pos_pad, dir_dim, density_softplus,
//          variant_train, white_bg, mip, then (kind, w_off, b_off, K, N) per
//          layer (HEAD_INTS + 5 n_layers ints in all).
// fparams: tail, half_pi, pos_freq[16], dir_freq[16] (pi * 2^l, or 2^l for
//          the mip arch, zero-padded).
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
  P->mip = iparams[8];
  if (P->pos_dim > 3 * (2 * MAX_FREQ + 1) || P->dir_dim > 3 * (2 * MAX_FREQ + 1))
    return cudaErrorInvalidValue;
  for (int i = 0; i < P->n_layers; ++i) {
    const int* q = iparams + HEAD_INTS + 5 * i;
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

// The ints after parse_params' own: where the render plan starts.
inline const int* plan_ints(const int* iparams, const KParams& P) {
  return iparams + HEAD_INTS + 5 * P.n_layers;
}

// column c of mip-NeRF's view encoding [v, sin(v 2^l) for l, sin(v 2^l +
// pi/2) for l] (freq = 2^l): all the sines first, each octave a 3-vector
__device__ inline float encode_view_mip(const float* v, int c, int n_dim, const float* freq,
                                        float half_pi) {
  if (c < 3) return v[c];
  if (c >= n_dim) return 0.0f;
  const int per = (n_dim - 3) / 2, t = c - 3, hi = t >= per, r = t - (hi ? per : 0);
  float u = __fmul_rn(v[r % 3], freq[r / 3]);
  if (hi) u = __fadd_rn(u, half_pi);
  return sinf(u);
}

// The Gaussian (mean, diagonal covariance) of the conical frustum [t0, t1]
// of the cone with apex o, axis d (not normalised) and radius r at unit
// distance: mip-NeRF's stable conical_frustum_to_gaussian and
// lift_gaussian, in the operation order of ops/encoding.py.
__device__ __forceinline__ void frustum_gaussian(const float* o, const float* d, float r,
                                                 float t0, float t1, float* mean, float* cov) {
  const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
  const float hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
  const float mu2 = __fmul_rn(mu, mu), hw2 = __fmul_rn(hw, hw);
  const float hw4 = __fmul_rn(hw2, hw2);
  const float den = __fadd_rn(__fmul_rn(mu2, 3.0f), hw2);
  const float t_mean = __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(mu, 2.0f), hw2), den));
  const float t_var = __fsub_rn(
      __fdiv_rn(hw2, 3.0f),
      __fmul_rn(__fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(mu2, 12.0f), hw2)), __fmul_rn(den, den)),
                4.0f / 15.0f));
  const float r_var = __fmul_rn(
      __fmul_rn(r, r), __fsub_rn(__fadd_rn(__fmul_rn(mu2, 0.25f), __fmul_rn(hw2, 5.0f / 12.0f)),
                                 __fmul_rn(__fdiv_rn(hw4, den), 4.0f / 15.0f)));
  const float dd[3] = {__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1]), __fmul_rn(d[2], d[2])};
  const float mag = fmaxf(__fadd_rn(__fadd_rn(dd[0], dd[1]), dd[2]), 1e-10f);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    mean[j] = __fadd_rn(__fmul_rn(d[j], t_mean), o[j]);
    cov[j] = __fadd_rn(__fmul_rn(t_var, dd[j]),
                       __fmul_rn(r_var, __fsub_rn(1.0f, __fdiv_rn(dd[j], mag))));
  }
}

}  // namespace nerf
