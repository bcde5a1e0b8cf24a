// Fused NeRF render kernel for Hopper (sm_90a): points -> positional
// encoding -> MLP -> alpha compositing, one launch per frame.
//
// Replaces the Pallas TPU kernel of sfm_nerf_tpu/kernels/fused_render.py
// (`_make_kernel`, reached by `fused_render_rays` for rgb and by
// `fused_render_rays_weights` with emit_weights=True).  The template flag
// EMIT_WEIGHTS selects the second entry point.
//
// Bound on this card: operations.  Per point the active arch does 655,488
// MACs (fc1 16,128; 4 hidden 262,144; skip 81,664; 3 hidden 196,608;
// densfeat 65,792; rgb1 feature rows 32,768; rgb2 384), 1.311 MFLOP; an
// 800x800 frame at 256 samples is 214.8 TFLOP, 0.217 s at the H100's
// published 989 TFLOP/s dense bf16 rate.  Its bytes (rays, depths, 1.3 MB of
// weights, rgb out) are under 0.7 GB, 0.2 ms at 3.35 TB/s.
//
// What the design does about it: all activations of a chunk of 128 sample
// points stay in shared memory as bf16 and never reach device memory; the
// ten products run on the tensor cores (WMMA bf16 x bf16 -> f32) with the
// weights streamed through a double-buffered shared-memory slab (cp.async),
// so each weight element is read from L2 once per chunk.  This is the simple
// first version: 8 warps per block, one block per SM, WMMA instead of wgmma,
// no TMA and no warp specialisation, so it runs far from the tensor-core
// bound.
//
// The blocking, the layer chain, the compositing and the numerics kept from
// the TPU kernel are in nerf_device.cuh, shared with the training kernels.
// White background adds the final transmittance ('train' variant only, the
// wrapper raises otherwise).

#include "nerf_device.cuh"

using namespace nerf;

namespace {

template <bool EMIT_WEIGHTS>
__global__ void __launch_bounds__(THREADS, 1)
fused_render_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                    const float* __restrict__ z, int n_rays, int n_sample,
                    const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                    const __grid_constant__ KParams P, float* __restrict__ rgb_out,
                    float* __restrict__ w_out) {
  extern __shared__ __align__(128) char smem_raw[];
  Smem s;
  smem_layout(P, smem_raw, &s, false);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = n_sample;

  for (int ray = blockIdx.x; ray < n_rays; ray += gridDim.x) {
    const float o[3] = {origins[ray * 3], origins[ray * 3 + 1], origins[ray * 3 + 2]};
    const float d[3] = {dirs[ray * 3], dirs[ray * 3 + 1], dirs[ray * 3 + 2]};
    setup_ray(P, W, s, d);
    float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

    for (int c0 = 0; c0 < S; c0 += M) {
      prepare_chunk(P, s, o, d, z + (size_t)ray * S, S, c0);
      forward_chunk(P, W, B, s, nullptr, 0);
      if (warp == 0)
        composite_chunk(P, s, S, c0, EMIT_WEIGHTS ? w_out + (size_t)ray * S : nullptr,
                        T, acc_r, acc_g, acc_b);
      __syncthreads();
    }
    if (tid == 0) {
      const float bg = P.white_bg ? T : 0.0f;
      rgb_out[ray * 3] = acc_r + bg;
      rgb_out[ray * 3 + 1] = acc_g + bg;
      rgb_out[ray * 3 + 2] = acc_b + bg;
    }
  }
}

template <bool EMIT>
int launch(const float* o, const float* d, const float* z, int n_rays, int n_sample,
           const void* w, const float* b, const KParams& P, float* rgb, float* wts,
           cudaStream_t stream) {
  const int smem = smem_layout(P, nullptr, nullptr, false);
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_kernel<EMIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_render_kernel<EMIT>, THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int grid = sms * per_sm;
  if (grid > n_rays) grid = n_rays;
  fused_render_kernel<EMIT><<<grid, THREADS, smem, stream>>>(
      o, d, z, n_rays, n_sample, static_cast<const __nv_bfloat16*>(w), b, P, rgb, wts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// iparams and fparams: see parse_params in nerf_device.cuh.
// Returns 0 or a cudaError_t code.
int sfm_fused_render(const float* origins, const float* dirs, const float* z,
                     int n_rays, int n_sample, const void* weights,
                     const float* biases, const int* iparams, const float* fparams,
                     float* rgb_out, float* w_out, int emit_weights, void* stream) {
  KParams P;
  const cudaError_t perr = parse_params(iparams, fparams, &P);
  if (perr != cudaSuccess) return perr;
  if (n_rays <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return emit_weights
             ? launch<true>(origins, dirs, z, n_rays, n_sample, weights, biases, P, rgb_out, w_out, st)
             : launch<false>(origins, dirs, z, n_rays, n_sample, weights, biases, P, rgb_out, w_out, st);
}

const char* sfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
