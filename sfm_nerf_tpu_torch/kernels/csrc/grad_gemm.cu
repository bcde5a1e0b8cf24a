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
// the stashes it reads are about 5.6 KB a point each way, 24 GB (7 ms at
// 3.35 TB/s), more where a cotangent block is read by several row tiles.
//
// What the design does about it:
// - one block per (task, point slice): a task is one layer, up to two
//   64-row tiles of its weight (one per consumer warpgroup, sharing the
//   cotangent tile) and up to 256 of its columns, so the cotangents are read
//   once per 128 weight rows and each activation block once;
// - one producer thread streams, per 64-point record, the task's activation
//   blocks and cotangent blocks into a ring of stages with bulk copies that
//   complete on mbarriers; the consumers run m64n256k16 wgmma with both
//   operands read MN-major from the swizzled images as they are (the
//   records are 128-byte-swizzled rows of 64 values, one row per point, so
//   no transpose is ever made);
// - each consumer warpgroup keeps its 64 x 256 f32 sum in registers across
//   the whole slice and writes it once to the slice's partial gradient;
//   the slices' partials are summed in index order by a second kernel
//   (fused_train.cu sfm_reduce_add).  No atomics: a run is bit-reproducible.
// Rows and columns past a tile's real extent multiply whatever the ring
// holds and are never written.

#include "sm90_mlp.cuh"

namespace {

constexpr int BLOCK_BYTES = sm90::KB_BYTES;            // one 64 x 64 bf16 image block
constexpr int BLOCK_ELEMS = BLOCK_BYTES / 2;
constexpr int D_BLOCKS = 4;                            // 256 columns
constexpr int STAGE_BYTES = (2 + D_BLOCKS) * BLOCK_BYTES;
constexpr int STAGES = 4;
constexpr int MAX_TASKS = 64;
constexpr int TASK_INTS = 13;

struct Task {
  int w_off;              // element offset of the layer's packed (k_rows, n) weight
  int n;                  // its columns (row stride)
  int n0, ncols;          // this task's columns [n0, n0 + ncols), ncols <= 256
  int d_block, d_blocks;  // its cotangent blocks in a record
  int n_tiles;            // 64-row weight tiles: 1 or 2
  int k0[2], k_rows[2];   // per tile: first weight row, real rows
  int a_block[2];         // per tile: its activation block in a record
};

struct Gemm {
  Task tasks[MAX_TASKS];
  int n_tasks, n_split, n_rec;
  long long rec_act, rec_cot;   // elements per record
  int w_total;
};

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
      sm90::mbar_init(empty + 8 * i, sm90::EMPTY_ARRIVALS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int task = blockIdx.x / G.n_split, split = blockIdx.x % G.n_split;
  const Task& T = G.tasks[task];
  const int r0 = (int)((long long)G.n_rec * split / G.n_split);
  const int r1 = (int)((long long)G.n_rec * (split + 1) / G.n_split);
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (g == sm90::CONSUMERS) {
    // ---- producer: one thread streams the records' blocks ----
    sm90::regs_dealloc<40>();
    if (threadIdx.x == sm90::CONSUMERS * 128) {
      const int bytes = (T.n_tiles + T.d_blocks) * BLOCK_BYTES;
      for (int r = r0, i = 0; r < r1; ++r, ++i) {
        const uint32_t slot = i % STAGES;
        sm90::mbar_wait(empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
        const uint32_t stage = ring + slot * STAGE_BYTES;
        sm90::mbar_expect_tx(full + 8 * slot, bytes);
        for (int t = 0; t < T.n_tiles; ++t)
          sm90::bulk_copy(stage + t * BLOCK_BYTES,
                          act + r * G.rec_act + (long long)T.a_block[t] * BLOCK_ELEMS,
                          BLOCK_BYTES, full + 8 * slot);
        sm90::bulk_copy(stage + 2 * BLOCK_BYTES,
                        cot + r * G.rec_cot + (long long)T.d_block * BLOCK_ELEMS,
                        T.d_blocks * BLOCK_BYTES, full + 8 * slot);
      }
    }
  } else {
    // ---- consumers: warpgroup g owns weight tile g of the task ----
    sm90::regs_alloc<232>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int r = r0, i = 0; r < r1; ++r, ++i) {
      const uint32_t slot = i % STAGES;
      sm90::mbar_wait(full + 8 * slot, (i / STAGES) & 1);
      const uint32_t stage = ring + slot * STAGE_BYTES;
      // a task with one tile leaves warpgroup 1 multiplying stale rows,
      // which it never writes: no branch around the products
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = sm90::desc_sw128_mn(stage + g * BLOCK_BYTES + ks * 2048, BLOCK_BYTES);
        const uint64_t db = sm90::desc_sw128_mn(stage + 2 * BLOCK_BYTES + ks * 2048, BLOCK_BYTES);
        sm90::Wgmma<256, 1>::mma(acc, da, db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive_lane0(empty + 8 * slot, lane);
    }
    // rows 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
    if (g < T.n_tiles) {
      float* out = partials + (size_t)split * G.w_total + T.w_off +
                   (size_t)T.k0[g] * T.n + T.n0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + (lane >> 2) + 8 * h;
        if (row < T.k_rows[g]) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = 8 * j + 2 * (lane & 3);
            if (col < T.ncols)
              *reinterpret_cast<float2*>(out + (size_t)row * T.n + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// partials (n_split, w_total) f32: slice s's sum over records
// [n_rec s / n_split, n_rec (s + 1) / n_split) of every task's rows and
// columns (elements no task covers are left as they are).  tasks: n_tasks x
// TASK_INTS ints in Task order (kernels/fused_train.py:gemm_tasks).  act:
// (n_rec, rec_act) and cot: (n_rec, rec_cot) bf16 records.  Returns 0 or a
// cudaError_t code.
int sfm_grad_gemm(const void* act, const void* cot, const int* tasks, int n_tasks, int n_split,
                  int n_rec, long long rec_act, long long rec_cot, int w_total, float* partials,
                  void* stream) {
  if (n_tasks < 1 || n_tasks > MAX_TASKS || n_split < 1 || n_split > n_rec ||
      rec_act % BLOCK_ELEMS || rec_cot % BLOCK_ELEMS)
    return cudaErrorInvalidValue;
  Gemm G;
  for (int i = 0; i < n_tasks; ++i) {
    const int* q = tasks + i * TASK_INTS;
    G.tasks[i] = Task{q[0], q[1], q[2], q[3], q[4], q[5], q[6], {q[7], q[10]}, {q[8], q[11]},
                      {q[9], q[12]}};
    const Task& t = G.tasks[i];
    if (t.ncols < 1 || t.ncols > 256 || t.d_blocks < 1 || t.d_blocks > D_BLOCKS ||
        t.n_tiles < 1 || t.n_tiles > 2 || t.k_rows[0] < 1 || t.k_rows[0] > 64 ||
        (t.n_tiles == 2 && (t.k_rows[1] < 1 || t.k_rows[1] > 64)) || t.n % 2 || t.n0 % 64)
      return cudaErrorInvalidValue;
  }
  G.n_tasks = n_tasks;
  G.n_split = n_split;
  G.n_rec = n_rec;
  G.rec_act = rec_act;
  G.rec_cot = rec_cot;
  G.w_total = w_total;
  const int smem = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(grad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  grad_gemm_kernel<<<n_tasks * n_split, sm90::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(act), static_cast<const __nv_bfloat16*>(cot), G, partials);
  return cudaGetLastError();
}

const char* sfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
