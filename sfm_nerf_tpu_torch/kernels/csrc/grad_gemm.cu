// The weight gradient of the split NeRF training step for Hopper (sm_90a):
// for every packed layer l, dW_l[k, n] = sum over the points p of a ray
// group of A_l[p, k] * D_l[p, n], with A_l the layer's input activation
// (the forward sweep's stash, fused_render.cu STASH) and D_l the cotangent
// of its output (the reverse walk's stash, fused_train.cu), both
// bf16 in 64-point records of swizzled 64 x 64 blocks.
//
// Replaces, with the two launches before it, the weight-gradient half of
// the Pallas TPU kernels of sfm_nerf_tpu/kernels/fused_train.py
// (`_make_step_kernel`, reached by `fused_mse_loss` and
// `fused_mse_loss_weights`, and `_make_bwd_kernel`, the backward of
// `fused_render_train`), which sum act^T d_h over their ray tiles in VMEM
// scratch across the sequential grid.
//
// Bound on this card: bytes.  At 8,192 rays x 256 samples the products are
// one forward's worth, 2.75 TFLOP (2.8 ms at 989 TFLOP/s dense bf16), while
// the stash blocks it needs are 87 of 8 KB a 64-point record, 23.4 GB a
// step: 7.0 ms at 3.35 TB/s of HBM.  Measured on an H100, the kernel runs
// as fast without its products as with them: the stream of stash blocks
// from HBM through the ring sets its pace (~2.4 TB/s of distinct bytes,
// where bulk copies of whole records read 3.1), not the tensor cores and
// not L2.
//
// What the design does about it:
// - clusters of two blocks: a job gives each block of the cluster up to two
//   64-row weight tiles (one per consumer warpgroup) of one layer, over the
//   same columns and records, so a cluster holds 256 weight rows.  Each
//   block bulk-copies its own activation blocks; each cotangent block is
//   fetched once, by a multicast bulk copy into both blocks' ring stage,
//   half of a record's issued by each block's producer.  A ring slot's empty
//   barrier counts both blocks' consumer warps (remote arrivals through
//   mapa), so neither producer refills it before both have read it.  Layers
//   whose tiles leave one over (an odd 64-row tile) pair it with another
//   layer's in a job without multicast, each block on its own cotangents.
//   A 256 x 256 layer takes 8 blocks a record from L2 instead of 12; the
//   flat packing 92 instead of 135 (kernels/fused_train.py:gemm_jobs);
// - one wave: as many clusters as fit on the card at once, each taking an
//   equal share of the jobs' bytes (jobs in order, records in order; a
//   cluster's share may start and end inside a job), so no second partial
//   wave idles most of the card at the end;
// - a ring slot is a whole record of a unit (the largest copies; slots of
//   half a record, twice as many, were slower), released as soon as its
//   products retire, so all four stages stay in flight;
// - the consumers run wgmma at the job's own width (n16, n64, n128, n256;
//   n256 plus n16 for a layer of 257-272 columns), both operands read
//   MN-major from the swizzled images as they are (no transpose is ever
//   made), from one set of accumulator registers whatever the width;
// - each consumer warpgroup sums 64 records at a time in registers (the
//   tensor cores' f32 sums lose precision over longer chains) and adds
//   each run to the partial row of its share of the job
//   (fused_train.py:gemm_segments); the rows are summed in index order by a
//   second kernel (fused_train.cu sfm_reduce_add).  No atomics: a run is
//   bit-reproducible.
// Rows and columns past a tile's real extent multiply whatever the ring
// holds and are never written.

#include "sm90_mlp.cuh"

namespace {

constexpr int BLOCK_BYTES = sm90::KB_BYTES;            // one 64 x 64 bf16 image block
constexpr int BLOCK_ELEMS = BLOCK_BYTES / 2;
constexpr int CLUSTER = 2;
constexpr int D_BLOCKS = 5;                            // 256 + 16 columns
constexpr int STAGE_BYTES = (2 + D_BLOCKS) * BLOCK_BYTES;   // a record's blocks of one unit
constexpr int STAGES = 4;
constexpr int MAX_JOBS = 24;
constexpr int UNIT_INTS = 14;
constexpr int JOB_INTS = 2 + CLUSTER * UNIT_INTS;
constexpr int EMPTY_ARRIVALS = CLUSTER * sm90::EMPTY_ARRIVALS;
constexpr int FLUSH_RECS = 64;                         // records a register sum runs over
// setmaxnreg: the producer warpgroup gives up registers for the consumers'
// sums (2 x 128 x 224 + 128 x 56 <= 65,536)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

// one block's share of a job: up to two 64-row tiles of a layer's weight
struct Unit {
  int w_off;              // element offset of the layer's packed (k_rows, n) weight
  int n;                  // its columns (row stride)
  int ncols, width;       // columns [0, ncols) by wgmma of width `width` (>= ncols)
  int extra;              // columns [256, 256 + extra) by n16 from cotangent block 4
  int d_block, d_blocks;  // its cotangent blocks in a record
  int n_tiles;            // 64-row weight tiles: 0, 1 or 2
  int k0[2], k_rows[2];   // per tile: first weight row, real rows
  int a_block[2];         // per tile: its activation block in a record
};

struct Job {
  int multicast;          // both units read the same cotangent blocks, fetched once
  int cost;               // blocks the job fetches a record (both blocks together)
  Unit u[CLUSTER];
};

struct Gemm {
  Job jobs[MAX_JOBS];
  int n_jobs, n_rec;
  long long rec_act, rec_cot;   // elements per record
  int w_total;
};

// the first record of a job whose first byte lies at or after cost offset x
__device__ __forceinline__ int first_record(long long x, int cost, int n_rec) {
  if (x <= 0) return 0;
  const long long r = (x + cost - 1) / cost;
  return r < n_rec ? (int)r : n_rec;
}

// Consumer warpgroup g's tile of its sum into ``out`` (the partial row's
// weights), added to what it holds if ``add``: rows 16 warp + lane / 4
// (+ 8), columns 8 j + 2 (lane % 4) (+ 1).
template <int W, bool EXTRA>
__device__ __forceinline__ void store(const Unit& U, int g, int warp, int lane,
                                      const float (&acc)[W / 2], const float (&acc16)[8],
                                      float* out, bool add) {
  if (g >= U.n_tiles) return;
  float* o = out + U.w_off + (size_t)U.k0[g] * U.n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + (lane >> 2) + 8 * h;
    if (row >= U.k_rows[g]) continue;
#pragma unroll
    for (int j = 0; j < W / 8 + (EXTRA ? 2 : 0); ++j) {
      const bool extra = j >= W / 8;
      const int col = 8 * (extra ? j - W / 8 : j) + 2 * (lane & 3);
      if (col >= (extra ? U.extra : U.ncols)) continue;
      float2* p = reinterpret_cast<float2*>(o + (size_t)row * U.n + (extra ? 256 : 0) + col);
      float2 v = extra ? make_float2(acc16[4 * (j - W / 8) + 2 * h], acc16[4 * (j - W / 8) + 2 * h + 1])
                       : make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (add) {
        const float2 was = *p;
        v = make_float2(was.x + v.x, was.y + v.y);
      }
      *p = v;
      // at most 16 loads in flight: the compiler would hoist them all and
      // spill the sums
      if (j % 16 == 15) asm volatile("" ::: "memory");
    }
  }
}

// Consumer warpgroup g: the products of records [r0, r1) of its unit into
// its tile of ``out``, FLUSH_RECS records at a time: the tensor cores' f32
// sums lose precision over long chains, so each run of records starts from
// zero (scale-d off) and is added to the partial in order.  A slot is
// released as soon as its products retire: the kernel is bound by the
// stream of stash bytes, and a slot held while the next one fills would
// take a stage out of the ring.  acc and acc16 are the warpgroup's one set
// of sums, whatever the width (W / 2 of acc used).  i counts the block's
// ring slots.
template <int W, bool EXTRA>
__device__ __forceinline__ void consume(const Unit& U, int g, int warp, int lane, uint32_t ring,
                                        uint32_t full, uint32_t empty, uint32_t& i, int r0,
                                        int r1, float* out, float (&acc_all)[128],
                                        float (&acc16)[8]) {
  float(&acc)[W / 2] = *reinterpret_cast<float(*)[W / 2]>(acc_all);
  for (int c0 = r0; c0 < r1; c0 += FLUSH_RECS) {
    const int c1 = min(r1, c0 + FLUSH_RECS);
    for (int r = c0; r < c1; ++r, ++i) {
      const uint32_t slot = i % STAGES;
      sm90::mbar_wait(full + 8 * slot, (i / STAGES) & 1);
      const uint32_t stage = ring + slot * STAGE_BYTES;
      // a unit with fewer tiles leaves its other warpgroups multiplying
      // stale rows, which they never write: no branch around the products
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int keep = r > c0 || ks > 0;
        const uint64_t da = sm90::desc_sw128_mn(stage + g * BLOCK_BYTES + ks * 2048, BLOCK_BYTES);
        const uint64_t db = sm90::desc_sw128_mn(stage + 2 * BLOCK_BYTES + ks * 2048, BLOCK_BYTES);
        sm90::Wgmma<W, 1, 1>::mma(acc, da, db, keep);
        if (EXTRA) {
          const uint64_t de =
              sm90::desc_sw128_mn(stage + (2 + 4) * BLOCK_BYTES + ks * 2048, BLOCK_BYTES);
          sm90::Wgmma<16, 1, 1>::mma(acc16, da, de, keep);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive_cluster_lanes(empty + 8 * slot, lane, CLUSTER);
    }
    store<W, EXTRA>(U, g, warp, lane, acc, acc16, out, c0 > r0);
  }
}

__global__ void __launch_bounds__(sm90::THREADS, 1)
grad_gemm_kernel(const __nv_bfloat16* __restrict__ act, const __nv_bfloat16* __restrict__ cot,
                 const __grid_constant__ Gemm G, float* __restrict__ partials) {
  extern __shared__ __align__(128) char smem_raw[];
  char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = sm90::smem_addr(base);
  const uint32_t full = sm90::smem_addr(base + STAGES * STAGE_BYTES);
  const uint32_t empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(full + 8 * i, 1);
      sm90::mbar_init(empty + 8 * i, EMPTY_ARRIVALS);
    }
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();

  // the cluster's share of the jobs' bytes: [b0, b1) of total
  const int rank = (int)sm90::cluster_rank();
  const int q = blockIdx.x / CLUSTER, n_clusters = gridDim.x / CLUSTER;
  long long total = 0;
  for (int j = 0; j < G.n_jobs; ++j) total += (long long)G.jobs[j].cost * G.n_rec;
  const long long b0 = total * q / n_clusters, b1 = total * (q + 1) / n_clusters;
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (g == sm90::CONSUMERS) {
    // ---- producer: one thread streams the records' blocks ----
    // (everything a copy needs is in registers before a job's loop: the
    // mbarrier asm clobbers memory, so a field read through G inside it
    // would be loaded again before every copy, and the copies would be
    // issued at the pace of those loads)
    sm90::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      const long long rec_act = G.rec_act, rec_cot = G.rec_cot;
      const int n_rec = G.n_rec, n_jobs = G.n_jobs;
      uint32_t i = 0;
      long long p = 0;
      for (int j = 0; j < n_jobs; ++j) {
        const Job& J = G.jobs[j];
        const Unit& U = J.u[rank];
        const int cost = J.cost, multicast = J.multicast, n_tiles = U.n_tiles;
        const int a0 = U.a_block[0], a1 = U.a_block[1], nd = U.d_blocks;
        const int r0 = first_record(b0 - p, cost, n_rec);
        const int r1 = first_record(b1 - p, cost, n_rec);
        p += (long long)cost * n_rec;
        // the cotangent blocks this producer issues: all of its own, or its
        // half of the shared ones (block 0 the first ceil(d / 2))
        const int half = (nd + 1) / 2;
        const int d0 = multicast && rank ? half : 0;
        const int d1 = multicast && !rank ? half : nd;
        const uint16_t mask = multicast ? (uint16_t)((1 << CLUSTER) - 1) : (uint16_t)0;
        // two tiles of adjacent activation blocks: one copy
        const bool joined = n_tiles == 2 && a1 == a0 + 1;
        const int a_bytes = joined ? 2 * BLOCK_BYTES : BLOCK_BYTES;
        const int d_bytes = (d1 - d0) * BLOCK_BYTES;
        const int bytes = (n_tiles + nd) * BLOCK_BYTES;   // landing in this block
        const __nv_bfloat16* pa0 = act + r0 * rec_act + (long long)a0 * BLOCK_ELEMS;
        const __nv_bfloat16* pa1 = act + r0 * rec_act + (long long)a1 * BLOCK_ELEMS;
        const __nv_bfloat16* pd = cot + r0 * rec_cot + (long long)(U.d_block + d0) * BLOCK_ELEMS;
        for (int r = r0; r < r1; ++r, ++i) {
          const uint32_t slot = i % STAGES;
          sm90::mbar_wait(empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
          const uint32_t stage = ring + slot * STAGE_BYTES;
          const uint32_t bar = full + 8 * slot;
          sm90::mbar_expect_tx(bar, bytes);
          if (n_tiles) sm90::bulk_copy(stage, pa0, a_bytes, bar);
          if (n_tiles == 2 && !joined) sm90::bulk_copy(stage + BLOCK_BYTES, pa1, BLOCK_BYTES, bar);
          if (d_bytes) {
            if (mask)
              sm90::bulk_copy_multicast(stage + (2 + d0) * BLOCK_BYTES, pd, d_bytes, bar, mask);
            else
              sm90::bulk_copy(stage + (2 + d0) * BLOCK_BYTES, pd, d_bytes, bar);
          }
          pa0 += rec_act;
          pa1 += rec_act;
          pd += rec_cot;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup g owns tile g of its unit ----
    sm90::regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    float acc[128], acc16[8];
#pragma unroll
    for (int k = 0; k < 128; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc16[k] = 0.0f;
    uint32_t i = 0;
    long long p = 0;
    for (int j = 0; j < G.n_jobs; ++j) {
      const Job& J = G.jobs[j];
      const int r0 = first_record(b0 - p, J.cost, G.n_rec);
      const int r1 = first_record(b1 - p, J.cost, G.n_rec);
      // this share's partial row: clusters before the one holding the
      // job's first byte take none of it
      const int row = q - (int)(((p + 1) * n_clusters - 1) / total);
      p += (long long)J.cost * G.n_rec;
      if (r1 <= r0) continue;
      const Unit& U = J.u[rank];
      float* out = partials + (size_t)row * G.w_total;
      if (U.width == 256) {
        if (U.extra)
          consume<256, true>(U, g, warp, lane, ring, full, empty, i, r0, r1, out, acc, acc16);
        else
          consume<256, false>(U, g, warp, lane, ring, full, empty, i, r0, r1, out, acc, acc16);
      } else if (U.width == 128) {
        consume<128, false>(U, g, warp, lane, ring, full, empty, i, r0, r1, out, acc, acc16);
      } else if (U.width == 64) {
        consume<64, false>(U, g, warp, lane, ring, full, empty, i, r0, r1, out, acc, acc16);
      } else {
        consume<16, false>(U, g, warp, lane, ring, full, empty, i, r0, r1, out, acc, acc16);
      }
    }
  }
  // neither block leaves while the other may still copy into it or arrive
  // on its barriers
  sm90::cluster_sync();
}

constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

cudaError_t set_smem() {
  return cudaFuncSetAttribute(grad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

cudaLaunchConfig_t launch_config(int n_clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * CLUSTER);
  cfg.blockDim = dim3(sm90::THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool unit_ok(const Unit& u) {
  if (u.n_tiles == 0) return u.d_blocks == 0;
  const bool width_ok = u.width == 16 || u.width == 64 || u.width == 128 || u.width == 256;
  return width_ok && u.n_tiles <= 2 && u.ncols >= 1 && u.ncols <= u.width && u.n % 2 == 0 &&
         u.extra >= 0 && u.extra <= 16 && (u.extra == 0 || (u.width == 256 && u.ncols == 256)) &&
         u.ncols + u.extra <= u.n && u.d_blocks >= (u.ncols + 63) / 64 + (u.extra > 0) &&
         u.d_blocks <= D_BLOCKS && u.k_rows[0] >= 1 && u.k_rows[0] <= 64 &&
         (u.n_tiles < 2 || (u.k_rows[1] >= 1 && u.k_rows[1] <= 64));
}

}  // namespace

extern "C" {

// The clusters of grad_gemm_kernel that fit on the current device at once
// (the launch's grid is twice that), into *n_clusters.  Returns 0 or a
// cudaError_t code.
int sfm_grad_gemm_clusters(int* n_clusters) {
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(sms / CLUSTER, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n_clusters, grad_gemm_kernel, &cfg);
}

// partials (rows, w_total) f32: each cluster's share of each job's records
// written to the job's partial row of that share (kernels/fused_train.py:
// gemm_segments; elements no job covers are left as they are).  jobs:
// n_jobs x JOB_INTS ints in Job order (fused_train.py:gemm_jobs).  act:
// (n_rec, rec_act) and cot: (n_rec, rec_cot) bf16 records.  Returns 0 or a
// cudaError_t code.
int sfm_grad_gemm(const void* act, const void* cot, const int* jobs, int n_jobs, int n_clusters,
                  int n_rec, long long rec_act, long long rec_cot, int w_total, float* partials,
                  void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS || n_clusters < 1 || n_rec < 1 || rec_act % BLOCK_ELEMS ||
      rec_cot % BLOCK_ELEMS)
    return cudaErrorInvalidValue;
  Gemm G;
  for (int i = 0; i < n_jobs; ++i) {
    const int* q = jobs + i * JOB_INTS;
    Job& J = G.jobs[i];
    J.multicast = q[0];
    J.cost = q[1];
    for (int c = 0; c < CLUSTER; ++c) {
      const int* u = q + 2 + c * UNIT_INTS;
      J.u[c] = Unit{u[0], u[1], u[2], u[3], u[4], u[5], u[6], u[7], {u[8], u[11]}, {u[9], u[12]},
                    {u[10], u[13]}};
      if (!unit_ok(J.u[c])) return cudaErrorInvalidValue;
    }
    if (J.cost < 1 || (J.multicast && (J.u[0].d_block != J.u[1].d_block ||
                                       J.u[0].d_blocks != J.u[1].d_blocks ||
                                       J.u[0].width != J.u[1].width)))
      return cudaErrorInvalidValue;
  }
  G.n_jobs = n_jobs;
  G.n_rec = n_rec;
  G.rec_act = rec_act;
  G.rec_cot = rec_cot;
  G.w_total = w_total;
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(n_clusters, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, grad_gemm_kernel, static_cast<const __nv_bfloat16*>(act),
                           static_cast<const __nv_bfloat16*>(cot), G, partials);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* sfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
