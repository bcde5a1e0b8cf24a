// Fused NeRF training kernels for Hopper (sm_90a): the forward of
// nerf_device.cuh plus a hand-written backward through the compositing and
// the MLP.
//
// Replaces, with fused_render.cu's STASH sweep and grad_gemm.cu, the Pallas
// TPU kernels of sfm_nerf_tpu/kernels/fused_train.py:
// - `fused_mse_loss` and `fused_mse_loss_weights` (`_make_step_kernel`):
//   MODE_REV is the middle launch of the split step.  Per ray it reads the
//   forward sweep's stash (fused_render.cu STASH: every layer input, the
//   per-point density and colours, tb), makes the cotangent
//   g = (rgb - target) * 2 / (3 N) itself, walks the chunks in reverse and
//   writes each layer's bf16 output cotangent D to a cotangent stash, which
//   grad_gemm.cu turns into the weight grads (sum over points of A^T D).
//   Bias grads and rgb1's direction rows stay here, in per-block partials.
//   MODE_STEP is the single-launch step that recomputes each chunk's forward
//   just before its backward (keep_activations=False): rgb and every grad
//   from one launch and the fixed-order reduction;
// - `fused_render_train` forward (`_make_fwd_kernel`): MODE_FWD, rgb and
//   the transmittance entering each chunk, tb (N, n_chunks);
// - `fused_render_train` backward (`_make_bwd_kernel`): MODE_BWD, the same
//   recomputing reverse walk with the caller's g (N, 3) and the stored tb.
//
// Bound on this card: operations.  The forward of 8,192 rays x 256 samples
// is 2.75 TFLOP (655,488 MACs per point); a step needs the forward, d_h W^T
// and act^T d_h for every layer, three forwards' worth: 8.25 TFLOP, 8.3 ms
// at the H100's 989 TFLOP/s dense bf16 rate.  The bytes a step must move
// (rays, depths, targets, 1.3 MB of weights in, 2.6 MB of grads out) are
// tens of MB, microseconds at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel keeps a ray tile's whole
// layer chain on chip; here the backward of a chunk of 128 points needs ten
// activations of 64 KB and a block has 227 KB of shared memory.  So:
// - MODE_REV reads each layer's input activation back from the stash when
//   it reaches that layer; MODE_STEP and MODE_BWD recompute the chunk's
//   forward into a per-block stash just before its backward;
// - the backward of a layer holds two buffers in shared memory: the
//   layer's input activation A and the cotangent D of its output (bf16).
//   The bias grad is the column sum of D, and D W^T, masked by A > 0, is
//   written over A as the next cotangent; the weights stream through the
//   same cp.async slabs as the forward, transposed (col-major B fragments).
//   MODE_STEP / MODE_BWD also add act^T D into this block's partial weight
//   gradient in device memory (accumulator tiles loaded and stored, all
//   warps splitting the weight's row tiles); MODE_REV writes D out instead;
// - grads are deterministic: every block owns one partial buffer (zeroed by
//   the caller) and the ray -> block map is fixed, and a second kernel sums
//   the partials over the blocks in index order.  No atomics.
// The products are WMMA, one block of 8 warps per SM.
//
// Numerics kept from the TPU kernels, beside those of nerf_device.cuh:
// one_m = expf(-x) + 1e-10, never 1 - alpha + 1e-10; dL/dalpha =
// q T - R / one_m with R the strict suffix sum of q w carried across chunks
// in reverse; dsigma = dalpha * delta * expf(-x); softplus' = 1 -
// expf(-density), relu mask on the legacy arch; a white background shifts q
// by -sum(g); cotangents are rounded to bf16 where they enter a product,
// sums and biases stay f32.

#include "nerf_device.cuh"

using namespace nerf;

namespace {

enum Mode { MODE_STEP = 0, MODE_FWD = 1, MODE_BWD = 2, MODE_REV = 3 };

constexpr int IMG_BLOCK = 64 * 64;   // bf16 elements of one 64-row x 64-column image block

struct TrainArgs {
  const float *origins, *dirs, *z, *target, *g_in;
  float *rgb_out, *tb;
  __nv_bfloat16* stash_act;   // MODE_STEP / BWD: (blocks, n_layers - 1, M, stash_w);
                              // MODE_REV: the forward sweep's records (rays, 2 n_chunks, rec_act)
  float* stash_pt;            // MODE_REV: (rays, 2 n_chunks, 64, 4): density, r, g, b
  __nv_bfloat16* stash_cot;   // MODE_REV: (rays, 2 n_chunks, rec_cot) cotangent records
  float* partials;            // (blocks, grad_stride): MODE_STEP / BWD weights then biases;
                              // MODE_REV rgb1's direction rows (dir_dim x 128) then biases
  int n_rays, n_sample, n_chunks, stash_w, w_total, grad_stride;
  int rec_act, enc_kb, act_kb, rec_cot;   // MODE_REV record layout, in elements / blocks
  int cot_off[MAX_LAYERS];                // MODE_REV: first block of layer l's D in a record
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

// gW (k_rows x N, f32, device memory) += A[:, :k_rows]^T @ D[:, :N], A and
// D bf16 in shared memory, all 128 rows; warps split the row tiles of gW.
__device__ void accumulate_dw(float* gW, int N, const __nv_bfloat16* A, int a_ld, int k_rows,
                              const __nv_bfloat16* D, int d_ld) {
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB / 16];
  for (int kt = warp; kt < k_rows / 16; kt += WARPS) {
    for (int n0 = 0; n0 < N; n0 += NB) {
      const int nfr = min(NB, N - n0) / 16;
      float* tile = gW + (size_t)kt * 16 * N + n0;
#pragma unroll
      for (int f = 0; f < NB / 16; ++f)
        if (f < nfr) wmma::load_matrix_sync(acc[f], tile + f * 16, N, wmma::mem_row_major);
      for (int m0 = 0; m0 < M; m0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
        wmma::load_matrix_sync(a, A + m0 * a_ld + kt * 16, a_ld);
#pragma unroll
        for (int f = 0; f < NB / 16; ++f) {
          if (f < nfr) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, D + m0 * d_ld + n0 + f * 16, d_ld);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < NB / 16; ++f)
        if (f < nfr) wmma::store_matrix_sync(tile + f * 16, acc[f], N, wmma::mem_row_major);
    }
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
// layer's input activation from the stash.  Needs s.drgb, s.ddens, s.ext.
// REV: the stash is two 64-row records of the forward sweep (rec[0], rec[1])
// and each layer's output cotangent D goes to the cotangent records
// (cot[0], cot[1]) in place of act^T D; otherwise the stash is the
// recomputing modes' dense (n_layers - 1, M, stash_w) block and act^T D is
// added to gW.
template <bool REV>
__device__ void mlp_backward(const KParams& P, const TrainArgs& a,
                             const __nv_bfloat16* __restrict__ W, const Smem& s,
                             const __nv_bfloat16* stash, const __nv_bfloat16* const* rec,
                             __nv_bfloat16* const* cot, float* gW, float* gB) {
  const int tid = threadIdx.x;
  const int ld = s.act_ld;
  const int nl = P.n_layers;
  __nv_bfloat16* A = s.act0;   // the layer's input activation
  __nv_bfloat16* D = s.act1;   // the cotangent of its output
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  // layer input j (the output of layer j) into A, ncols wide
  auto load_input = [&](int j, int ncols) {
    if constexpr (REV) {
      const size_t off = (size_t)(a.enc_kb + j * a.act_kb) * IMG_BLOCK;
      rows_from_image(A, ld, rec[0] + off, rec[1] + off, ncols);
    } else {
      rows_from_global(A, ld, stash + (size_t)j * M * a.stash_w, a.stash_w, ncols);
    }
  };

  load_input(nl - 2, RGB1_N);
  for (int e = tid; e < M * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    D[r * ld + c] = c < 3 ? __float2bfloat16_rn(s.drgb[r * 3 + c]) : zero;
  }
  for (int li = nl - 1; li >= 0; --li) {
    const LayerDesc& L = P.layers[li];
    const int k_main = L.kind == K_FC1 ? 0 : (L.kind == K_SKIP ? P.hidden : L.K);
    const int k_ext = (L.kind == K_FC1 || L.kind == K_SKIP) ? P.pos_pad : 0;
    __syncthreads();   // A and D complete
    accumulate_db(gB + L.b_off, L.N, D, ld, L.kind == K_RGB1 ? s.ddir : nullptr);
    if constexpr (REV) {
      const size_t off = (size_t)a.cot_off[li] * IMG_BLOCK;
      rows_to_image(D, ld, cot[0] + off, cot[1] + off, L.N);
    } else {
      if (k_main) accumulate_dw(gW + L.w_off, L.N, A, ld, k_main, D, ld);
      if (k_ext)
        accumulate_dw(gW + L.w_off + (size_t)k_main * L.N, L.N, s.ext, s.ext_ld, k_ext, D, ld);
    }
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

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
fused_train_kernel(const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                   const __grid_constant__ KParams P, const __grid_constant__ TrainArgs a) {
  extern __shared__ __align__(128) char smem_raw[];
  Smem s;
  smem_layout(P, smem_raw, &s, true);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = a.n_sample, nc = a.n_chunks;
  constexpr bool REV = MODE == MODE_REV;
  const size_t act_slot = (size_t)(P.n_layers - 1) * M * a.stash_w;
  __nv_bfloat16* stash_act =
      (MODE == MODE_STEP || MODE == MODE_BWD) ? a.stash_act + (size_t)blockIdx.x * act_slot
                                              : nullptr;
  float* part = MODE == MODE_FWD ? nullptr : a.partials + (size_t)blockIdx.x * a.grad_stride;
  const LayerDesc& rgb1 = P.layers[P.n_layers - 2];
  // REV: direction rows then biases; otherwise the packed weights then biases
  float* gW = REV ? nullptr : part;
  float* gB = part + (REV ? P.dir_dim * RGB1_N : a.w_total);
  float* gdir = REV ? part : part + rgb1.w_off + (size_t)P.hidden * RGB1_N;

  for (int ray = blockIdx.x; ray < a.n_rays; ray += gridDim.x) {
    const float o[3] = {a.origins[ray * 3], a.origins[ray * 3 + 1], a.origins[ray * 3 + 2]};
    const float d[3] = {a.dirs[ray * 3], a.dirs[ray * 3 + 1], a.dirs[ray * 3 + 2]};
    const float* z_ray = a.z + (size_t)ray * S;
    float* tb_ray = a.tb + (size_t)ray * nc;
    setup_ray(P, W, s, d);

    if (MODE == MODE_STEP || MODE == MODE_FWD) {
      float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
      for (int c = 0; c < nc; ++c) {
        if (tid == 0) tb_ray[c] = T;
        prepare_chunk(P, s, o, d, z_ray, S, c * M);
        forward_chunk(P, W, B, s, nullptr, a.stash_w);
        if (warp == 0) composite_chunk(P, s, S, c * M, nullptr, T, acc_r, acc_g, acc_b);
        __syncthreads();
      }
      if (tid == 0) {
        const float bg = P.white_bg ? T : 0.0f;
        const float rgb[3] = {acc_r + bg, acc_g + bg, acc_b + bg};
        float gsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          a.rgb_out[ray * 3 + j] = rgb[j];
          if (MODE == MODE_STEP) {
            s.g[j] = (rgb[j] - a.target[ray * 3 + j]) * a.gscale;
            gsum += s.g[j];
          }
        }
        if (MODE == MODE_STEP) s.g[3] = P.white_bg ? gsum : 0.0f;
      }
    }
    if ((MODE == MODE_BWD || REV) && tid == 0) {
      float gsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // REV: rgb is the forward sweep's, the cotangent is the MSE's
        s.g[j] = REV ? (a.rgb_out[ray * 3 + j] - a.target[ray * 3 + j]) * a.gscale
                     : a.g_in[ray * 3 + j];
        gsum += s.g[j];
      }
      s.g[3] = P.white_bg ? gsum : 0.0f;
    }
    if (MODE != MODE_FWD) {
      if (tid < RGB1_N) s.ddir[tid] = 0.0f;
      __syncthreads();   // s.g, s.ddir and (MODE_STEP) tb_ray are visible
      float S_carry = 0.0f;
      for (int c = nc - 1; c >= 0; --c) {
        const __nv_bfloat16* rec[2] = {nullptr, nullptr};
        __nv_bfloat16* cot[2] = {nullptr, nullptr};
        if constexpr (REV) {
          // the chunk's two 64-row records of the forward sweep
          const size_t q = (size_t)ray * 2 * nc + 2 * c;
          for (int h = 0; h < 2; ++h) {
            rec[h] = a.stash_act + (q + h) * a.rec_act;
            cot[h] = a.stash_cot + (q + h) * a.rec_cot;
          }
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
        } else {
          prepare_chunk(P, s, o, d, z_ray, S, c * M);
          forward_chunk(P, W, B, s, stash_act, a.stash_w);
        }
        if (warp == 0) composite_backward(P, s, tb_ray[c], S_carry);
        __syncthreads();
        mlp_backward<REV>(P, a, W, s, stash_act, rec, cot, gW, gB);
      }
      // rgb1's direction rows, once per ray: dext^T (d_dirpart summed over
      // the ray's chunks), plain f32 FMAs
      for (int e = tid; e < P.dir_dim * RGB1_N; e += THREADS)
        gdir[e] = fmaf(s.dext[e / RGB1_N], s.ddir[e % RGB1_N], gdir[e]);
      __syncthreads();
    }
  }
}

// dst += the sum over blocks, in index order, of partials[b][i]: element
// i < n_a to dst_a[i], the rest to dst_b[i - n_a] (the split step adds each
// ray group's partials to the grads in group order; MODE_STEP / BWD add
// theirs to zeroed grads)
__global__ void reduce_add_kernel(const float* __restrict__ partials, int n_blocks, int stride,
                                  int n_a, float* dst_a, float* dst_b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float sum = 0.0f;
  for (int b = 0; b < n_blocks; ++b) sum += partials[(size_t)b * stride + i];
  float* dst = i < n_a ? dst_a + i : dst_b + (i - n_a);
  *dst += sum;
}

template <int MODE>
int launch(const void* w, const float* b, const KParams& P, const TrainArgs& a, int n_blocks,
           float* grads, cudaStream_t stream) {
  const int smem = smem_layout(P, nullptr, nullptr, true);
  cudaError_t err = cudaFuncSetAttribute(fused_train_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_train_kernel<MODE>,
                                                           THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  fused_train_kernel<MODE><<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(w), b, P, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (MODE == MODE_STEP || MODE == MODE_BWD) {
    if ((err = cudaMemsetAsync(grads, 0, sizeof(float) * a.grad_stride, stream)) != cudaSuccess)
      return err;
    reduce_add_kernel<<<(a.grad_stride + 255) / 256, 256, 0, stream>>>(
        a.partials, n_blocks, a.grad_stride, a.grad_stride, grads, grads);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// One entry point for the kernels.  mode: 0 the recomputing step
// (fused_mse_loss with keep_activations=False), 1 forward and 2 backward
// (fused_render_train), 3 the split step's reverse walk.  iparams and
// fparams: see parse_params in nerf_device.cuh.  The caller allocates
// everything:
//   tb        (n_rays, n_chunks) f32, written by modes 0 and 1, read by 0, 2, 3;
//   stash_act modes 0, 2: (n_blocks, n_layers - 1, 128, stash_w) bf16 scratch;
//             mode 3: the forward sweep's records (layout: layout[0..3] =
//             rec_act, enc_kb, act_kb, rec_cot, then n_layers cotangent
//             block offsets; kernels/fused_train.py:stash_layout);
//   stash_pt  mode 3: (n_rays, 2 n_chunks, 64, 4) f32; stash_cot mode 3:
//             (n_rays, 2 n_chunks, rec_cot) bf16, written;
//   rgb_out   (n_rays, 3) f32, written by modes 0 and 1, read by mode 3;
//   partials  (n_blocks, grad_stride) f32, ZEROED: modes 0, 2: grad_stride =
//             w_total + the bias buffer's length; mode 3: grad_stride =
//             dir_dim * 128 + the bias buffer's length;
//   grads     modes 0, 2: (grad_stride,) f32, weight grads in the packed
//             layout then bias grads (written by the reduction, launched
//             here); mode 3 launches no reduction (sfm_reduce_add).
// n_blocks must not exceed n_rays; one block runs per SM.  Returns 0 or a
// cudaError_t.
int sfm_fused_train(int mode, const float* origins, const float* dirs, const float* z,
                    const float* target, const float* g_in, int n_rays, int n_sample,
                    const void* weights, const float* biases, const int* iparams,
                    const float* fparams, float* rgb_out, float* tb, void* stash_act,
                    float* stash_pt, void* stash_cot, const int* layout, float* partials,
                    float* grads, int n_blocks, int stash_w, int w_total, int grad_stride,
                    float gscale, void* stream) {
  KParams P;
  const cudaError_t perr = parse_params(iparams, fparams, &P);
  if (perr != cudaSuccess) return perr;
  if (n_rays <= 0) return cudaSuccess;
  if (n_blocks < 1 || n_blocks > n_rays || P.hidden > 256 || P.hidden % 16 ||
      stash_w < P.hidden || stash_w < RGB1_N)
    return cudaErrorInvalidValue;
  TrainArgs a{};
  a.origins = origins;
  a.dirs = dirs;
  a.z = z;
  a.target = target;
  a.g_in = g_in;
  a.rgb_out = rgb_out;
  a.tb = tb;
  a.stash_act = static_cast<__nv_bfloat16*>(stash_act);
  a.stash_pt = stash_pt;
  a.stash_cot = static_cast<__nv_bfloat16*>(stash_cot);
  a.partials = partials;
  a.n_rays = n_rays;
  a.n_sample = n_sample;
  a.n_chunks = (n_sample + M - 1) / M;
  a.stash_w = stash_w;
  a.w_total = w_total;
  a.grad_stride = grad_stride;
  a.gscale = gscale;
  if (mode == MODE_REV) {
    if (!layout) return cudaErrorInvalidValue;
    a.rec_act = layout[0];
    a.enc_kb = layout[1];
    a.act_kb = layout[2];
    a.rec_cot = layout[3];
    for (int i = 0; i < P.n_layers; ++i) a.cot_off[i] = layout[4 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_STEP:
      return launch<MODE_STEP>(weights, biases, P, a, n_blocks, grads, st);
    case MODE_FWD:
      return launch<MODE_FWD>(weights, biases, P, a, n_blocks, grads, st);
    case MODE_BWD:
      return launch<MODE_BWD>(weights, biases, P, a, n_blocks, grads, st);
    case MODE_REV:
      return launch<MODE_REV>(weights, biases, P, a, n_blocks, grads, st);
  }
  return cudaErrorInvalidValue;
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
