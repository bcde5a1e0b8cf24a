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
// layer input, the per-point density and colours, tb), walks the chunks in
// reverse and writes each layer's bf16 output cotangent D to a cotangent
// stash, which grad_gemm.cu turns into the weight grads (sum over points of
// A^T D).  Bias grads and rgb1's direction rows stay here, in per-block
// partials; reduce_add_kernel adds partials to the grads in a fixed order.
//
// Bound on this card: operations.  A step of 8,192 rays x 256 samples needs
// the forward (2.75 TFLOP, 655,488 MACs per point), d_h W^T and act^T d_h
// for every layer, three forwards' worth: 8.25 TFLOP, 8.3 ms at the H100's
// 989 TFLOP/s dense bf16 rate; this walk's share is the d_h W^T products,
// one forward's worth.  The bytes a step must move (rays, depths, targets,
// 1.3 MB of weights in, 2.6 MB of grads out) are tens of MB, microseconds
// at 3.35 TB/s.
//
// What the design does about it.  The backward of a chunk of 128 points
// needs ten activations of 64 KB and a block has 227 KB of shared memory.
// So the walk reads each layer's input activation back from the stash when
// it reaches that layer, and the backward of a layer holds two buffers in
// shared memory: the layer's input activation A and the cotangent D of its
// output (bf16).  The bias grad is the column sum of D, and D W^T, masked by
// A > 0, is written over A as the next cotangent; the weights stream through
// double-buffered cp.async tiles, transposed (col-major B fragments).  The
// products are WMMA, one block of 8 warps per SM; grads are deterministic:
// every block owns one partial buffer (zeroed by the caller) and the ray ->
// block map is fixed.  No atomics.
//
// Numerics kept from the TPU kernels: one_m = expf(-x) + 1e-10, never
// 1 - alpha + 1e-10; dL/dalpha = q T - R / one_m with R the strict suffix
// sum of q w carried across chunks in reverse; the exclusive transmittance
// as T expf(csum + x); dsigma = dalpha * delta * expf(-x); softplus' =
// 1 - expf(-density), relu mask on the legacy arch; a white background
// shifts q by -sum(g); cotangents are rounded to bf16 where they enter a
// product, sums and biases stay f32.

#include "nerf_device.cuh"

using namespace nerf;

namespace {

constexpr int IMG_BLOCK = 64 * 64;   // bf16 elements of one 64-row x 64-column image block

struct RevArgs {
  const float *dirs, *z, *tb;
  const float *rgb, *target;   // the MSE cotangent's inputs, when g_in is null
  const float* g_in;           // the caller's cotangent (rays, 3), or null
  const __nv_bfloat16* stash_act;   // the forward sweep's records (rays, 2 n_chunks, rec_act)
  const float* stash_pt;            // (rays, 2 n_chunks, 64, 4): density, r, g, b
  __nv_bfloat16* stash_cot;         // (rays, 2 n_chunks, rec_cot) cotangent records, written
  float* partials;   // (blocks, grad_stride): rgb1's direction rows (dir_dim x 128), biases
  int n_rays, n_sample, n_chunks, grad_stride;
  int rec_act, enc_kb, act_kb, rec_cot;   // the record layout, in elements / blocks
  int cot_off[MAX_LAYERS];                // first block of layer l's D in a record
  float gscale;
};

// Rows [0, 128) x columns [0, ncols) (a multiple of 8) between a shared
// buffer of row stride ld and the swizzled images of two 64-row chunks
// (img[0] rows 0-63, img[1] rows 64-127): element (r, c) of an image sits in
// block c / 64 at row r, 16-byte chunk (c / 8 % 8) ^ (r % 8) (sm90::sw128).
__device__ void rows_from_image(__nv_bfloat16* buf, int ld, const __nv_bfloat16* img0,
                                const __nv_bfloat16* img1, int ncols) {
  const int vec = ncols / 8;
  for (int i = threadIdx.x; i < M * vec; i += THREADS) {
    const int r = i / vec, v = i - r * vec, rr = r & 63;
    const __nv_bfloat16* src = (r < 64 ? img0 : img1) + (v >> 3) * IMG_BLOCK + rr * 64 +
                               (((v & 7) ^ (rr & 7)) << 3);
    *reinterpret_cast<uint4*>(buf + r * ld + v * 8) = *reinterpret_cast<const uint4*>(src);
  }
}

__device__ void rows_to_image(const __nv_bfloat16* buf, int ld, __nv_bfloat16* img0,
                              __nv_bfloat16* img1, int ncols) {
  const int vec = ncols / 8;
  for (int i = threadIdx.x; i < M * vec; i += THREADS) {
    const int r = i / vec, v = i - r * vec, rr = r & 63;
    __nv_bfloat16* dst = (r < 64 ? img0 : img1) + (v >> 3) * IMG_BLOCK + rr * 64 +
                         (((v & 7) ^ (rr & 7)) << 3);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf + r * ld + v * 8);
  }
}

// gB[:N] += column sums of D (and ``also``, the per-ray direction cotangent)
__device__ void accumulate_db(float* gB, int N, const __nv_bfloat16* D, int d_ld, float* also) {
  for (int col = threadIdx.x; col < N; col += THREADS) {
    float sum = 0.0f;
    for (int m = 0; m < M; ++m) sum += __bfloat162float(D[m * d_ld + col]);
    gB[col] += sum;
    if (also) also[col] += sum;
  }
}

// A[:, :k_out] = (D[:, :N] @ W[:k_out, :N]^T) where A > 0, else 0, for this
// warp's rows, in place (A holds the layer's input activation on entry and
// the cotangent of the layer before on exit).  Ends in __syncthreads.
__device__ void backward_input(const LayerDesc& L, const __nv_bfloat16* __restrict__ Wl,
                               const Smem& s, const __nv_bfloat16* D, __nv_bfloat16* A,
                               int k_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  float* scratch = s.scratch + warp * 256;
  const int n_pass = (k_out + KT - 1) / KT;
  const int n_ns = (L.N + NT - 1) / NT;
  const int total = n_pass * n_ns;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KT / 16];

  load_tile(s.slab0, SLABT_LD, Wl, L.N, 0, min(KT, k_out), 0, min(NT, L.N));
  for (int it = 0; it < total; ++it) {
    const int pass = it / n_ns, ni = it - pass * n_ns;
    const int k0 = pass * KT, kfr = min(KT, k_out - k0) / 16;
    const int n0 = ni * NT, ns = min(NT, L.N - n0);
    const __nv_bfloat16* slab = (it & 1) ? s.slab1 : s.slab0;
    if (it + 1 < total) {
      const int pp = (it + 1) / n_ns, pn = (it + 1) - pp * n_ns;
      load_tile((it & 1) ? s.slab0 : s.slab1, SLABT_LD, Wl, L.N, pp * KT,
                min(KT, k_out - pp * KT), pn * NT, min(NT, L.N - pn * NT));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (ni == 0) {
#pragma unroll
      for (int f = 0; f < KT / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
    }
    for (int nn = 0; nn < ns; nn += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, D + row0 * s.act_ld + n0 + nn, s.act_ld);
#pragma unroll
      for (int f = 0; f < KT / 16; ++f) {
        if (f < kfr) {
          // W's (k, n) tile read col-major is W^T's (n, k) tile
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, slab + f * 16 * SLABT_LD + nn, SLABT_LD);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    if (ni == n_ns - 1) {
#pragma unroll
      for (int f = 0; f < KT / 16; ++f) {
        if (f < kfr) {
          __syncwarp();
          wmma::store_matrix_sync(scratch, acc[f], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int idx = (row0 + (e >> 4)) * s.act_ld + k0 + f * 16 + (e & 15);
            const bool on = __bfloat162float(A[idx]) > 0.0f;
            A[idx] = __float2bfloat16_rn(on ? scratch[e] : 0.0f);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// Warp 0: the compositing backward of one chunk, from s.dens, s.rgb,
// s.dist, the cotangent s.g (g_r, g_g, g_b, white ? sum g : 0), the
// transmittance T_in entering the chunk and the suffix carry.  Writes the
// cotangents of the rgb head's pre-sigmoid output (s.drgb) and of the
// density head's pre-activation output (s.ddens).
__device__ void composite_backward(const KParams& P, const Smem& s, float T_in, float& S_carry) {
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

  const float g0 = s.g[0], g1 = s.g[1], g2 = s.g[2], gsum = s.g[3];
  float e[4], Ti[4], w[4], qv[4], qw[4];
  float lane_total = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = lane * 4 + q;
    e[q] = expf(-x[q]);
    Ti[q] = T_in * expf((excl + c[q]) + x[q]);
    w[q] = (1.0f - e[q]) * Ti[q];
    qv[q] = (s.rgb[i * 3] * g0 + s.rgb[i * 3 + 1] * g1 + s.rgb[i * 3 + 2] * g2) - gsum;
    qw[q] = qv[q] * w[q];
    lane_total += qw[q];
  }
  // strict suffix sum of q w over the chunk: lanes above, then samples
  // above within the lane
  float sfx = lane_total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_down_sync(0xffffffffu, sfx, off);
    if (lane + off < 32) sfx += n;
  }
  float above = __shfl_down_sync(0xffffffffu, sfx, 1);
  if (lane == 31) above = 0.0f;
  const float total = __shfl_sync(0xffffffffu, sfx, 0);
  float R = above + S_carry;
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    const int i = lane * 4 + q;
    const float dalpha = qv[q] * Ti[q] - R / (e[q] + 1e-10f);
    const float dsigma = dalpha * s.dist[i] * e[q];
    const float dens = s.dens[i];
    const float dact = P.density_softplus ? 1.0f - expf(-dens) : (dens > 0.0f ? 1.0f : 0.0f);
    s.ddens[i] = dsigma * dact;
    const float r0 = s.rgb[i * 3], r1 = s.rgb[i * 3 + 1], r2 = s.rgb[i * 3 + 2];
    s.drgb[i * 3] = (w[q] * g0) * r0 * (1.0f - r0);
    s.drgb[i * 3 + 1] = (w[q] * g1) * r1 * (1.0f - r1);
    s.drgb[i * 3 + 2] = (w[q] * g2) * r2 * (1.0f - r2);
    R += qw[q];
  }
  S_carry += total;
}

// The MLP backward of one chunk: walks the layers in reverse, reading each
// layer's input activation from the chunk's two 64-row records of the
// forward sweep (rec[0], rec[1]) and writing each layer's output cotangent
// D to the cotangent records (cot[0], cot[1]).  Needs s.drgb and s.ddens.
__device__ void mlp_backward(const KParams& P, const RevArgs& a,
                             const __nv_bfloat16* __restrict__ W, const Smem& s,
                             const __nv_bfloat16* const* rec, __nv_bfloat16* const* cot,
                             float* gB) {
  const int tid = threadIdx.x;
  const int ld = s.act_ld;
  const int nl = P.n_layers;
  __nv_bfloat16* A = s.act0;   // the layer's input activation
  __nv_bfloat16* D = s.act1;   // the cotangent of its output
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  // layer input j (the output of layer j) into A, ncols wide
  auto load_input = [&](int j, int ncols) {
    const size_t off = (size_t)(a.enc_kb + j * a.act_kb) * IMG_BLOCK;
    rows_from_image(A, ld, rec[0] + off, rec[1] + off, ncols);
  };

  load_input(nl - 2, RGB1_N);
  for (int e = tid; e < M * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    D[r * ld + c] = c < 3 ? __float2bfloat16_rn(s.drgb[r * 3 + c]) : zero;
  }
  for (int li = nl - 1; li >= 0; --li) {
    const LayerDesc& L = P.layers[li];
    // the input cotangent reaches the previous layer's output only: the
    // skip layer's encoding rows and fc1's have none to pass on
    const int k_main = L.kind == K_FC1 ? 0 : (L.kind == K_SKIP ? P.hidden : L.K);
    __syncthreads();   // A and D complete
    accumulate_db(gB + L.b_off, L.N, D, ld, L.kind == K_RGB1 ? s.ddir : nullptr);
    const size_t off = (size_t)a.cot_off[li] * IMG_BLOCK;
    rows_to_image(D, ld, cot[0] + off, cot[1] + off, L.N);
    if (li == 0) break;
    __syncthreads();   // every warp has read A before it is overwritten
    backward_input(L, W + L.w_off, s, D, A, k_main);
    if (L.kind == K_RGB1) {
      // the density/feature head's cotangent: feature columns (just
      // written), then the density column, then zeros
      for (int e = tid; e < M * 16; e += THREADS) {
        const int r = e >> 4, c = e & 15;
        A[r * ld + P.hidden + c] = c == 0 ? __float2bfloat16_rn(s.ddens[r]) : zero;
      }
    }
    __nv_bfloat16* t = A;
    A = D;
    D = t;
    if (li >= 2) load_input(li - 2, P.layers[li - 2].kind == K_RGB1 ? RGB1_N : P.hidden);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
reverse_walk_kernel(const __nv_bfloat16* __restrict__ W, const __grid_constant__ KParams P,
                    const __grid_constant__ RevArgs a) {
  extern __shared__ __align__(128) char smem_raw[];
  Smem s;
  smem_layout(P, smem_raw, &s);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = a.n_sample, nc = a.n_chunks;
  float* gdir = a.partials + (size_t)blockIdx.x * a.grad_stride;   // direction rows
  float* gB = gdir + P.dir_dim * RGB1_N;                            // then biases

  for (int ray = blockIdx.x; ray < a.n_rays; ray += gridDim.x) {
    const float d[3] = {a.dirs[ray * 3], a.dirs[ray * 3 + 1], a.dirs[ray * 3 + 2]};
    const float* z_ray = a.z + (size_t)ray * S;
    encode_direction(P, s, d);
    if (tid == 0) {
      float gsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // the caller's cotangent, or the MSE's from the forward sweep's rgb
        s.g[j] = a.g_in ? a.g_in[ray * 3 + j]
                        : (a.rgb[ray * 3 + j] - a.target[ray * 3 + j]) * a.gscale;
        gsum += s.g[j];
      }
      s.g[3] = P.white_bg ? gsum : 0.0f;
    }
    if (tid < RGB1_N) s.ddir[tid] = 0.0f;
    __syncthreads();   // s.g, s.ddir and s.dext are visible
    float S_carry = 0.0f;
    for (int c = nc - 1; c >= 0; --c) {
      // the chunk's two 64-row records of the forward sweep
      const size_t q = (size_t)ray * 2 * nc + 2 * c;
      const __nv_bfloat16* rec[2] = {a.stash_act + q * a.rec_act,
                                     a.stash_act + (q + 1) * a.rec_act};
      __nv_bfloat16* cot[2] = {a.stash_cot + q * a.rec_cot, a.stash_cot + (q + 1) * a.rec_cot};
      if (tid < M) {
        const int si = c * M + tid;
        s.dist[tid] = si >= S ? 0.0f : si < S - 1 ? z_ray[si + 1] - z_ray[si] : P.tail;
        const float4 pt = reinterpret_cast<const float4*>(a.stash_pt)[q * 64 + tid];
        s.dens[tid] = pt.x;
        s.rgb[tid * 3] = pt.y;
        s.rgb[tid * 3 + 1] = pt.z;
        s.rgb[tid * 3 + 2] = pt.w;
      }
      __syncthreads();
      if (warp == 0) composite_backward(P, s, a.tb[(size_t)ray * nc + c], S_carry);
      __syncthreads();
      mlp_backward(P, a, W, s, rec, cot, gB);
    }
    // rgb1's direction rows, once per ray: dext^T (d_dirpart summed over
    // the ray's chunks), plain f32 FMAs
    for (int e = tid; e < P.dir_dim * RGB1_N; e += THREADS)
      gdir[e] = fmaf(s.dext[e / RGB1_N], s.ddir[e % RGB1_N], gdir[e]);
    __syncthreads();
  }
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

}  // namespace

extern "C" {

// The reverse walk of one ray group.  The cotangent is g_in (n_rays, 3) when
// it is not null, else (rgb - target) * gscale.  iparams and fparams: see
// parse_params in nerf_device.cuh.  The caller allocates everything:
//   tb        (n_rays, n_chunks) f32 and stash_act, stash_pt: the forward
//             sweep's (layout: layout[0..3] = rec_act, enc_kb, act_kb,
//             rec_cot, then n_layers cotangent block offsets;
//             kernels/fused_train.py:stash_layout);
//   stash_cot (n_rays, 2 n_chunks, rec_cot) bf16, written;
//   partials  (n_blocks, grad_stride) f32, ZEROED, grad_stride = dir_dim * 128
//             + the bias buffer's length (sfm_reduce_add sums them).
// n_blocks must not exceed n_rays; one block runs per SM.  Returns 0 or a
// cudaError_t.
int sfm_reverse_walk(const float* dirs, const float* z, const float* rgb, const float* target,
                     const float* g_in, float gscale, int n_rays, int n_sample,
                     const void* weights, const int* iparams, const float* fparams,
                     const float* tb, const void* stash_act, const float* stash_pt,
                     void* stash_cot, const int* layout, float* partials, int n_blocks,
                     int grad_stride, void* stream) {
  KParams P;
  cudaError_t err = parse_params(iparams, fparams, &P);
  if (err != cudaSuccess) return err;
  if (n_rays <= 0) return cudaSuccess;
  if (n_blocks < 1 || n_blocks > n_rays || P.hidden > 256 || P.hidden % 16 || !layout ||
      (!g_in && (!rgb || !target)))
    return cudaErrorInvalidValue;
  RevArgs a{};
  a.dirs = dirs;
  a.z = z;
  a.tb = tb;
  a.rgb = rgb;
  a.target = target;
  a.g_in = g_in;
  a.stash_act = static_cast<const __nv_bfloat16*>(stash_act);
  a.stash_pt = stash_pt;
  a.stash_cot = static_cast<__nv_bfloat16*>(stash_cot);
  a.partials = partials;
  a.n_rays = n_rays;
  a.n_sample = n_sample;
  a.n_chunks = (n_sample + M - 1) / M;
  a.grad_stride = grad_stride;
  a.gscale = gscale;
  a.rec_act = layout[0];
  a.enc_kb = layout[1];
  a.act_kb = layout[2];
  a.rec_cot = layout[3];
  for (int i = 0; i < P.n_layers; ++i) a.cot_off[i] = layout[4 + i];
  const int smem = smem_layout(P, nullptr, nullptr);
  if ((err = cudaFuncSetAttribute(reverse_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reverse_walk_kernel, THREADS,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  reverse_walk_kernel<<<n_blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(weights), P, a);
  return cudaGetLastError();
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
