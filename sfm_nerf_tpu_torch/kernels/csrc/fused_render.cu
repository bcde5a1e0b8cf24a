// Fused NeRF render kernel for Hopper (sm_90a): points -> positional
// encoding -> MLP -> alpha compositing, one launch per frame.
//
// Replaces the Pallas TPU kernel of sfm_nerf_tpu/kernels/fused_render.py
// (`_make_kernel`, reached by `fused_render_rays` for rgb and by
// `fused_render_rays_weights` with emit_weights=True).  The template flag
// EMIT_WEIGHTS selects the second entry point.  Compiled with TB it is also
// the forward of `fused_render_train` (sfm_nerf_tpu/kernels/fused_train.py
// `_make_fwd_kernel`): rgb and tb, the transmittance entering each
// 128-sample chunk, the residual its backward starts from.
//
// Bound on this card: operations.  Per point the active arch does 655,488
// MACs (fc1 16,128; 4 hidden 262,144; skip 81,664; 3 hidden 196,608;
// densfeat 65,792; rgb1 feature rows 32,768; rgb2 384), 1.311 MFLOP; an
// 800x800 frame at 256 samples is 214.8 TFLOP, 0.217 s at the H100's
// published 989 TFLOP/s dense bf16 rate.  Its bytes (rays, depths, 1.3 MB of
// weights, rgb out) are under 0.7 GB, 0.2 ms at 3.35 TB/s.
//
// What the design does about it (device code in sm90_mlp.cuh):
// - one persistent block per SM: two consumer warpgroups and a producer
//   warpgroup (setmaxnreg moves registers from the producer warpgroup to
//   the consumers);
// - each consumer warpgroup renders its own rays in chunks of 64
//   consecutive samples of one ray, carrying T and the rgb sums in
//   registers; rays go to (block, warpgroup) pairs in a fixed order, so the
//   output is deterministic;
// - the products run on wgmma (m64nNk16, bf16 x bf16 -> f32) with the
//   activations and the weights in shared memory; a ReLU product's
//   accumulators start at its bias and its epilogue (ReLU, bf16, stmatrix)
//   writes them back into the same rows, in place, with no block barrier;
// - one lane of the producer streams the weights, laid out once on the host
//   as the swizzled shared-memory image of each 64-row tile, through a ring
//   of bulk copies completing on mbarriers; both warpgroups read every
//   tile, so one fetch from L2 serves 128 points;
// - three warps of the producer encode each consumer's next chunk (64 rows,
//   accurate sinf) into its encoding buffer as soon as its skip layer has
//   read the current one: the two consumers run in step (they wait on the
//   same tiles), so an encoding done by the consumers themselves left the
//   tensor cores idle for a fifth of the time;
// - the block stages the biases in shared memory once, for every pass's
//   accumulators to start from (sm90_mlp.cuh, which also says why the two
//   consumers stay in step).
//
// TB and STASH change no arithmetic.  TB walks the ray in whole 128-sample
// chunks (a pad half has zero distances and adds exactly nothing, so rgb and
// the weights stay bit-equal to the render's) and writes per ray the
// transmittance entering each 128-sample chunk (tb).  STASH (the forward
// sweep of the split training step, kernels/fused_train.py; implies TB) also
// writes what the reverse walk and the weight-gradient GEMM read: per 64-row
// chunk the stash record of mlp_chunk (bulk copies of the encoding and of
// every layer input, see sm90_mlp.cuh) and per point (density, r, g, b) f32.
//
// MIP (the mip arch, kernels/fused_render.py:fused_render_cones and the
// cone training step): each ray is a cone, (radius, |d|) in ``cones``, over
// S intervals between S + 1 edges (z's row holds S + 1 values).  The
// encoder threads turn each interval into its conical frustum's Gaussian
// (nerf_device.cuh frustum_gaussian) and write its integrated encoding,
// exp(-cov 4^l / 2) sin(mean 2^l) and the same at + pi/2 (accurate expf
// and sinf, the sines skipped where the factor is 0): 16 octaves are 96
// columns, two encoding blocks.  The view direction is d / |d| under
// mip-NeRF's encoding; the bottleneck is linear (P_LIN); the rgb head is
// widened; a sample's distance is (t1 - t0) |d|, with no tail.
//
// The numerics of the TPU kernel are kept: exact f32 encoding phase and
// accurate sinf (encode() of nerf_device.cuh), bf16 rounding of the
// encoding and hidden activations, f32 biases and heads, 1 - alpha as
// expf(-x), the exclusive transmittance as expf(csum + x), zero distance
// past a ray's last sample.  White background adds the final transmittance
// ('train' variant only, the wrapper raises otherwise).

#include "nerf_device.cuh"
#include "sm90_mlp.cuh"

namespace {

using nerf::KParams;

// The position encoding of samples [c0, c0 + 64) of a ray into a
// warpgroup's encoding buffer, by the producer warpgroup's encoder thread
// e of ENCODERS: a task is one row (point o + d z, exact f32) and one
// frequency l, whose six columns 3 + 6l + j are sin(x_j pi 2^l) and
// sin(fl(x_j pi 2^l) + pi/2) (exact f32 phase, accurate sinf); task l = -1
// writes x and the zero pad.  The same values as encode() of
// nerf_device.cuh, without its divisions and its indexed local array.
//
// MIP: a task is one row (interval si, clamped to the last, of edges z_ray
// [si], z_ray[si + 1]) and one octave l, whose six columns 3 l + j and
// 3 L + 3 l + j are e_j sin(y_j) and e_j sin(y_j + pi/2), y = mean 2^l,
// e = exp(-cov 4^l / 2); octave 0 also writes the zero pad.
template <bool MIP>
__device__ __forceinline__ void encode_chunk(const KParams& P, char* enc_p, const float* o,
                                             const float* d, float radius,
                                             const float* __restrict__ z_ray, int S, int c0,
                                             int e) {
  auto put = [&](int row, int c, float v) {
    *reinterpret_cast<__nv_bfloat16*>(enc_p + sm90::sw128(row, c)) = __float2bfloat16_rn(v);
  };
  if constexpr (MIP) {
    const int n_oct = P.pos_dim / 6;
    for (int task = e; task < sm90::ROWS * n_oct; task += sm90::ENCODERS) {
      const int row = task & (sm90::ROWS - 1), l = task / sm90::ROWS;
      const int si = c0 + row < S ? c0 + row : S - 1;
      float mean[3], cov[3];
      nerf::frustum_gaussian(o, d, radius, z_ray[si], z_ray[si + 1], mean, cov);
      const float f = P.pos_freq[l], f2 = __fmul_rn(f, f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float y = __fmul_rn(mean[j], f);
        const float ef = expf(__fmul_rn(__fmul_rn(cov[j], f2), -0.5f));
        float sn = 0.0f, cs = 0.0f;
        if (ef != 0.0f) {   // far octaves: exp underflows, the product is 0 whatever the sine
          sn = sinf(y);
          cs = sinf(__fadd_rn(y, P.half_pi));
        }
        put(row, 3 * l + j, __fmul_rn(ef, sn));
        put(row, 3 * n_oct + 3 * l + j, __fmul_rn(ef, cs));
      }
      if (l == 0)
        for (int c = P.pos_dim; c < P.pos_pad; ++c) put(row, c, 0.0f);
    }
    return;
  }
  const int n_freq = (P.pos_dim - 3) / 6;
  for (int task = e; task < sm90::ROWS * (n_freq + 1); task += sm90::ENCODERS) {
    const int row = task & (sm90::ROWS - 1), l = task / sm90::ROWS - 1;
    const int si = c0 + row;
    const float zs = z_ray[si < S ? si : S - 1];
    const float x0 = __fadd_rn(o[0], __fmul_rn(d[0], zs));
    const float x1 = __fadd_rn(o[1], __fmul_rn(d[1], zs));
    const float x2 = __fadd_rn(o[2], __fmul_rn(d[2], zs));
    if (l < 0) {
      put(row, 0, x0);
      put(row, 1, x1);
      put(row, 2, x2);
      for (int c = P.pos_dim; c < P.pos_pad; ++c) put(row, c, 0.0f);
    } else {
      const float f = P.pos_freq[l];
      const float u0 = __fmul_rn(x0, f), u1 = __fmul_rn(x1, f), u2 = __fmul_rn(x2, f);
      const int c = 3 + 6 * l;
      put(row, c, sinf(u0));
      put(row, c + 1, sinf(u1));
      put(row, c + 2, sinf(u2));
      put(row, c + 3, sinf(__fadd_rn(u0, P.half_pi)));
      put(row, c + 4, sinf(__fadd_rn(u1, P.half_pi)));
      put(row, c + 5, sinf(__fadd_rn(u2, P.half_pi)));
    }
  }
}

// The distances of samples [c0, c0 + 64) of a ray (threads 0..63); the
// layer chain's barriers publish them before the compositing reads them.
// MIP: the interval lengths (t1 - t0) |d|, no tail.
template <bool MIP>
__device__ __forceinline__ void chunk_dists(const KParams& P, const sm90::Wg& w,
                                            const float* __restrict__ z_ray, int S, int c0,
                                            float norm) {
  if (w.tid < sm90::ROWS) {
    const int si = c0 + w.tid;
    if constexpr (MIP)
      w.dist[w.tid] = si >= S ? 0.0f : __fmul_rn(__fsub_rn(z_ray[si + 1], z_ray[si]), norm);
    else
      w.dist[w.tid] = si >= S ? 0.0f : si < S - 1 ? z_ray[si + 1] - z_ray[si] : P.tail;
  }
}

// Per ray: the encoded direction (rounded to bf16) and the direction head,
// bf16(encoded d) @ rgb1's direction rows, once; thread t owns column t.
// MIP: d is the unit view direction, under mip-NeRF's encoding.
template <bool MIP>
__device__ __forceinline__ void setup_ray(const KParams& P, const __nv_bfloat16* __restrict__ wd,
                                          const sm90::Wg& w, const float* d) {
  sm90::wg_sync(w.g);   // the previous ray's rgb1 epilogue is done with dirpart
  if (w.tid < P.dir_dim)
    w.dext[w.tid] = nerf::bf16_round(
        MIP ? nerf::encode_view_mip(d, w.tid, P.dir_dim, P.dir_freq, P.half_pi)
            : nerf::encode(d, w.tid, P.dir_dim, P.dir_freq, P.half_pi));
  sm90::wg_sync(w.g);
  float acc = 0.0f;
  for (int k = 0; k < P.dir_dim; ++k)
    acc = fmaf(w.dext[k], __bfloat162float(wd[k * nerf::RGB1_N + w.tid]), acc);
  w.dirpart[w.tid] = acc;
}

// Composite the chunk's 64 samples (threads 0..63 of the warpgroup, one
// sample each): a scan of -sigma*delta, the weights, the rgb sum; T and
// the sums are carried in every thread's registers.
template <bool EMIT>
__device__ __forceinline__ void composite_chunk(const KParams& P, const sm90::Wg& w, int S,
                                                int c0, float* __restrict__ w_ray, float& T,
                                                float& acc_r, float& acc_g, float& acc_b) {
  const bool mine = w.tid < sm90::ROWS;
  const float x = mine ? w.dens[w.tid] * w.dist[w.tid] : 0.0f;
  float incl = -x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (w.lane >= off) incl += n;
  }
  if (w.lane == 31 && w.warp < 2) w.red[w.warp] = incl;
  sm90::wg_sync(w.g);
  const float total = w.red[0] + w.red[1];
  float pr = 0.0f, pg = 0.0f, pb = 0.0f;
  if (mine) {
    const float csum = (w.warp == 1 ? w.red[0] : 0.0f) + incl;
    const float trans = P.variant_train ? expf(csum + x) : expf(csum);
    const float wt = (1.0f - expf(-x)) * (T * trans);
    if (EMIT && c0 + w.tid < S) w_ray[c0 + w.tid] = wt;
    pr = wt * w.rgb[w.tid * 3];
    pg = wt * w.rgb[w.tid * 3 + 1];
    pb = wt * w.rgb[w.tid * 3 + 2];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pr += __shfl_xor_sync(0xffffffffu, pr, off);
    pg += __shfl_xor_sync(0xffffffffu, pg, off);
    pb += __shfl_xor_sync(0xffffffffu, pb, off);
  }
  if (w.lane == 0 && w.warp < 2) {
    w.red[2 + 3 * w.warp] = pr;
    w.red[3 + 3 * w.warp] = pg;
    w.red[4 + 3 * w.warp] = pb;
  }
  sm90::wg_sync(w.g);
  acc_r += w.red[2] + w.red[5];
  acc_g += w.red[3] + w.red[6];
  acc_b += w.red[4] + w.red[7];
  T = T * expf(total);
}

// where TB writes tb (rays, ceil(S / 128)); STASH also act (rays,
// 2 ceil(S / 128), rec) bf16 records and pt (rays, 2 ceil(S / 128), 64) float4
struct StashOut {
  __nv_bfloat16* act;
  float4* pt;
  float* tb;
};

template <bool EMIT_WEIGHTS, bool WIDE, bool TB, bool STASH, bool MIP>
__global__ void __launch_bounds__(sm90::THREADS, 1)
fused_render_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                    const float* __restrict__ z, const float* __restrict__ cones, int n_rays,
                    int n_sample,
                    const __nv_bfloat16* __restrict__ img, const float* __restrict__ B,
                    const __grid_constant__ KParams P, const __grid_constant__ sm90::Plan plan,
                    float* __restrict__ rgb_out, float* __restrict__ w_out,
                    const __grid_constant__ StashOut st) {
  static_assert(TB || !STASH, "the stash's reverse walk reads tb");
  extern __shared__ __align__(128) char smem_raw[];
  char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  sm90::Ring ring;
  ring.base = sm90::smem_addr(base + plan.ring);
  ring.full = sm90::smem_addr(base + plan.bars);
  ring.empty = ring.full + 8 * sm90::MAX_STAGES;
  ring.stages = plan.stages;
  ring.stage_bytes = plan.stage_bytes;
  // encoding buffer barriers of warpgroup g: full at enc_bars + 8 g,
  // empty at enc_bars + 8 (CONSUMERS + g)
  const uint32_t enc_bars = ring.full + 16 * sm90::MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < plan.stages; ++i) {
      sm90::mbar_init(ring.full + 8 * i, 1);
      sm90::mbar_init(ring.empty + 8 * i, sm90::EMPTY_ARRIVALS);
    }
    for (int g = 0; g < sm90::CONSUMERS; ++g) {
      sm90::mbar_init(enc_bars + 8 * g, sm90::ENCODERS);
      sm90::mbar_init(enc_bars + 8 * (sm90::CONSUMERS + g), 4);
    }
    sm90::mbar_init_fence();
  }
  float* bias = reinterpret_cast<float*>(base + plan.bias);
  for (int i = threadIdx.x; i < plan.n_bias / 4; i += blockDim.x)
    reinterpret_cast<float4*>(bias)[i] = __ldg(reinterpret_cast<const float4*>(B) + i);
  __syncthreads();

  const int S = n_sample;
  const int zs = MIP ? S + 1 : S;   // a ray's row of z: depths, or the edges of its intervals
  // samples walked: TB rounds up to whole 128-sample chunks
  const int S_run = TB ? (S + 127) / 128 * 128 : S;
  const int n_chunks = (S_run + sm90::ROWS - 1) / sm90::ROWS;
  const size_t rec = (size_t)(plan.enc_kb + (P.n_layers - 1) * plan.act_kb) * (sm90::KB_BYTES / 2);
  const int step = sm90::CONSUMERS * gridDim.x;
  const int first = sm90::CONSUMERS * blockIdx.x;
  // ray slots of warpgroup 0 (warpgroup 1 has as many or one fewer)
  const int slots = first < n_rays ? (n_rays - first + step - 1) / step : 0;
  // the role, warp-uniform to the compiler (a divergent path around the
  // wgmmas would serialize them)
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (g == sm90::CONSUMERS) {
    // ---- producer warpgroup: warp 0 streams the weights, warps 1-3 encode ----
    sm90::regs_dealloc<40>();
    const int pw = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
    if (pw == 0) {
      if ((threadIdx.x & 31) == 0) sm90::produce(plan, img, ring, slots * n_chunks);
    } else {
      const int e = threadIdx.x - sm90::CONSUMERS * 128 - 32;
      uint32_t k[sm90::CONSUMERS] = {};
      for (int slot = 0; slot < slots; ++slot) {
        for (int c0 = 0; c0 < S_run; c0 += sm90::ROWS) {
          for (int wg = 0; wg < sm90::CONSUMERS; ++wg) {
            const int ray = slot * step + first + wg;
            if (ray >= n_rays) continue;
            sm90::mbar_wait(enc_bars + 8 * (sm90::CONSUMERS + wg), (k[wg] & 1) ^ 1);
            const float o[3] = {origins[ray * 3], origins[ray * 3 + 1], origins[ray * 3 + 2]};
            const float d[3] = {dirs[ray * 3], dirs[ray * 3 + 1], dirs[ray * 3 + 2]};
            encode_chunk<MIP>(P, base + plan.enc + wg * plan.enc_kb * sm90::KB_BYTES, o, d,
                              MIP ? cones[ray * 2] : 0.0f, z + (size_t)ray * zs, S, c0, e);
            sm90::fence_proxy_async();
            sm90::mbar_arrive(enc_bars + 8 * wg);
            ++k[wg];
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    sm90::regs_alloc<232>();
    sm90::Wg w;
    w.g = g;
    w.tid = threadIdx.x & 127;
    w.warp = w.tid >> 5;
    w.lane = w.tid & 31;
    w.act = sm90::smem_addr(base + plan.act + g * plan.act_kb * sm90::KB_BYTES);
    w.enc = sm90::smem_addr(base + plan.enc + g * plan.enc_kb * sm90::KB_BYTES);
    w.enc_full = enc_bars + 8 * g;
    w.enc_empty = enc_bars + 8 * (sm90::CONSUMERS + g);
    float* small = reinterpret_cast<float*>(base + plan.small) + g * sm90::SMALL_FLOATS;
    w.dist = small;             // 64
    w.dens = small + 64;        // 64
    w.rgb = small + 128;        // 64 x 3
    w.dirpart = small + 320;    // 128
    w.dext = small + 448;       // up to 99
    w.red = small + 560;        // 8
    const __nv_bfloat16* wd = img + plan.dir_off;
    uint32_t q = 0, k = 0;   // tiles and chunks consumed
    for (int slot = 0; slot < slots; ++slot) {
      const int ray = slot * step + first + g;
      if (ray >= n_rays) {
        for (int c = 0; c < n_chunks; ++c) sm90::skip_chunk(plan, w, ring, q);
        continue;
      }
      const float norm = MIP ? cones[ray * 2 + 1] : 1.0f;
      const float d[3] = {MIP ? __fdiv_rn(dirs[ray * 3], norm) : dirs[ray * 3],
                          MIP ? __fdiv_rn(dirs[ray * 3 + 1], norm) : dirs[ray * 3 + 1],
                          MIP ? __fdiv_rn(dirs[ray * 3 + 2], norm) : dirs[ray * 3 + 2]};
      const float* z_ray = z + (size_t)ray * zs;
      float* w_ray = EMIT_WEIGHTS ? w_out + (size_t)ray * S : nullptr;
      setup_ray<MIP>(P, wd, w, d);
      float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
      for (int c0 = 0; c0 < S_run; c0 += sm90::ROWS) {
        chunk_dists<MIP>(P, w, z_ray, S, c0, norm);
        if (TB && c0 % 128 == 0 && w.tid == 0)
          st.tb[(size_t)ray * (n_chunks / 2) + c0 / 128] = T;
        if constexpr (STASH) {
          const size_t ch = (size_t)ray * n_chunks + c0 / sm90::ROWS;
          sm90::mlp_chunk<WIDE, true, MIP>(plan, bias, P.density_softplus, w, ring, q, k++,
                                           st.act + ch * rec);
          if (w.tid < sm90::ROWS)
            st.pt[ch * sm90::ROWS + w.tid] = make_float4(
                w.dens[w.tid], w.rgb[w.tid * 3], w.rgb[w.tid * 3 + 1], w.rgb[w.tid * 3 + 2]);
        } else {
          sm90::mlp_chunk<WIDE, false, MIP>(plan, bias, P.density_softplus, w, ring, q, k++);
        }
        composite_chunk<EMIT_WEIGHTS>(P, w, S, c0, w_ray, T, acc_r, acc_g, acc_b);
      }
      if (w.tid == 0) {
        const float bg = P.white_bg ? T : 0.0f;
        rgb_out[ray * 3] = acc_r + bg;
        rgb_out[ray * 3 + 1] = acc_g + bg;
        rgb_out[ray * 3 + 2] = acc_b + bg;
      }
    }
    if constexpr (STASH) sm90::bulk_wait_all(w.tid == 0);
  }
}

template <bool EMIT, bool WIDE, bool TB, bool STASH, bool MIP>
int launch(const float* o, const float* d, const float* z, const float* cones, int n_rays,
           int n_sample, const void* img, const float* b, const KParams& P,
           const sm90::Plan& plan, float* rgb, float* wts, const StashOut& st,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_kernel<EMIT, WIDE, TB, STASH, MIP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.total);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int pairs = (n_rays + sm90::CONSUMERS - 1) / sm90::CONSUMERS;
  const int grid = pairs < sms ? pairs : sms;
  fused_render_kernel<EMIT, WIDE, TB, STASH, MIP><<<grid, sm90::THREADS, plan.total, stream>>>(
      o, d, z, cones, n_rays, n_sample, static_cast<const __nv_bfloat16*>(img), b, P, plan, rgb,
      wts, st);
  return cudaGetLastError();
}

// out: what the kernel writes beside rgb (and the weights)
enum Out { OUT_NONE = 0, OUT_TB = 1, OUT_STASH = 2 };

using Launch = decltype(&launch<false, false, false, false, false>);

// the instantiation for the run; the mip arch has no TB (two-kernel) route
template <bool MIP>
Launch pick(Out out, bool emit, bool wide) {
  if (out == OUT_STASH)
    return emit ? (wide ? launch<true, true, true, true, MIP> : launch<true, false, true, true, MIP>)
                : (wide ? launch<false, true, true, true, MIP> : launch<false, false, true, true, MIP>);
  if (out == OUT_TB) {   // the forward of fused_render_train: no weights
    if constexpr (MIP) return nullptr;
    else return wide ? launch<false, true, true, false, false> : launch<false, false, true, false, false>;
  }
  return emit ? (wide ? launch<true, true, false, false, MIP> : launch<true, false, false, false, MIP>)
              : (wide ? launch<false, true, false, false, MIP> : launch<false, false, false, false, MIP>);
}

int run(const float* origins, const float* dirs, const float* z, const float* cones,
        int n_rays, int n_sample, const void* weights, const float* biases,
        const int* iparams, const float* fparams, float* rgb_out, float* w_out,
        int emit_weights, Out out, const StashOut& st, void* stream) {
  KParams P;
  cudaError_t err = nerf::parse_params(iparams, fparams, &P);
  if (err != cudaSuccess) return err;
  sm90::Plan plan;
  if ((err = sm90::parse_plan(nerf::plan_ints(iparams, P), &plan)) != cudaSuccess) return err;
  if (P.dir_dim > nerf::RGB1_N || P.pos_pad > 64 * plan.enc_kb) return cudaErrorInvalidValue;
  if (P.mip && (!cones || !P.variant_train)) return cudaErrorInvalidValue;
  bool wide = true;
  for (int i = 0; i < plan.n_passes; ++i)
    if ((plan.passes[i].kind == sm90::P_RELU || plan.passes[i].kind == sm90::P_LIN) &&
        plan.passes[i].n != 256)
      wide = false;
  if (n_rays <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch go = P.mip ? pick<true>(out, emit_weights, wide) : pick<false>(out, emit_weights, wide);
  if (!go) return cudaErrorInvalidValue;
  return go(origins, dirs, z, cones, n_rays, n_sample, weights, biases, P, plan, rgb_out, w_out,
            st, s);
}

}  // namespace

extern "C" {

// weights: the tile image of kernels/fused_render.py:render_tile_image.
// iparams: parse_params (nerf_device.cuh), then at HEAD_INTS + 5 *
// n_layers the plan (sm90::parse_plan).  fparams: see parse_params.
// cones: (n_rays, 2) radius and |d| for the mip arch (z then holds
// n_sample + 1 edges a ray), else null.  Returns 0 or a cudaError_t code.
int sfm_fused_render(const float* origins, const float* dirs, const float* z, const float* cones,
                     int n_rays, int n_sample, const void* weights,
                     const float* biases, const int* iparams, const float* fparams,
                     float* rgb_out, float* w_out, int emit_weights, void* stream) {
  return run(origins, dirs, z, cones, n_rays, n_sample, weights, biases, iparams, fparams,
             rgb_out, w_out, emit_weights, OUT_NONE, StashOut{}, stream);
}

// The forward of fused_render_train: sfm_fused_render (rgb only) plus tb
// (n_rays, ceil(n_sample / 128)) f32, the transmittance entering each
// 128-sample chunk.
int sfm_fused_render_tb(const float* origins, const float* dirs, const float* z, int n_rays,
                        int n_sample, const void* weights, const float* biases,
                        const int* iparams, const float* fparams, float* rgb_out, float* tb,
                        void* stream) {
  return run(origins, dirs, z, nullptr, n_rays, n_sample, weights, biases, iparams, fparams,
             rgb_out, nullptr, 0, OUT_TB, StashOut{nullptr, nullptr, tb}, stream);
}

// The forward sweep of the split training step: sfm_fused_render plus the
// stash (StashOut; kernels/fused_train.py:stash_layout describes it).
int sfm_fused_render_stash(const float* origins, const float* dirs, const float* z,
                           const float* cones, int n_rays, int n_sample, const void* weights,
                           const float* biases, const int* iparams, const float* fparams,
                           float* rgb_out, float* w_out, int emit_weights, void* stash_act,
                           void* stash_pt, float* tb, void* stream) {
  const StashOut st{static_cast<__nv_bfloat16*>(stash_act), static_cast<float4*>(stash_pt), tb};
  return run(origins, dirs, z, cones, n_rays, n_sample, weights, biases, iparams, fparams,
             rgb_out, w_out, emit_weights, OUT_STASH, st, stream);
}

// The plan's shared-memory layout: out[0] bytes of dynamic shared memory a
// block takes, out[1] ring stages, out[2] bytes per stage.  Returns 0 or a
// cudaError_t code.
int sfm_fused_render_layout(const int* iparams, const float* fparams, int* out) {
  KParams P;
  cudaError_t err = nerf::parse_params(iparams, fparams, &P);
  if (err != cudaSuccess) return err;
  sm90::Plan plan;
  if ((err = sm90::parse_plan(nerf::plan_ints(iparams, P), &plan)) != cudaSuccess) return err;
  out[0] = plan.total;
  out[1] = plan.stages;
  out[2] = plan.stage_bytes;
  return cudaSuccess;
}

const char* sfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
