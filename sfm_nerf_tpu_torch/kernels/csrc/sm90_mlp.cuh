// Hopper building blocks for the NeRF MLP on one warpgroup's 64 rows:
// wgmma products with both operands in shared memory, a weight ring fed by
// bulk copies that complete on mbarriers, and the layer-chain epilogues
// (bias, ReLU, bf16 rounding, density, rgb) written from the accumulator
// registers straight back into the activation rows.
//
// Layouts (all "K-major, 128-byte swizzle", the canonical wgmma layout):
// - an activation buffer holds 64 rows x (64 * kb) bf16 columns as kb
//   blocks of 64 rows x 128 bytes; inside a block, the 16-byte chunk c of
//   row r sits at chunk c ^ (r % 8) (sw128 below).  The encoding buffer has
//   the same layout.
// - a weight tile is the shared-memory image of up to 64 weight rows (k) x
//   n columns, stored as n rows of 64 k-values (128 bytes), swizzled the
//   same way.  The host lays every tile out once (kernels/fused_render.py,
//   `render_plan` / `render_tile_image`), so the producer moves a tile with
//   one cp.async.bulk and no tensor map.  Read MN-major (desc_sw128_mn), a
//   tile's rows are W^T's: the reverse walk (fused_train.cu) multiplies by
//   W^T from the same image.
//
// A plan lists the products of one chunk in order (passes), each as its
// tiles in order; every chunk walks the same tiles, so the producer warp
// streams plan.tiles round after round through a ring of `stages` slots
// with full (bytes arrived) and empty (both consumer warpgroups done)
// mbarriers.  Both consumer warpgroups read every tile: one fetch from L2
// serves 128 points.
//
// The two consumer warpgroups run in lockstep: they wait on the same ring
// slots and issue each tile's products together.  Staggering them, so that
// one's epilogue runs under the other's products, measured slower on the
// hidden-256 plan in both forms tried: turns at the tensor cores (CUTLASS's
// ping-pong consumers) left one accumulator chain issuing, K1 +9%; a
// trailing warpgroup held ring slots the leading one needed, which left
// 1-2 tiles of lookahead on the 4-slot ring against copies from an L2 the
// weight stream keeps busy, K1 +0 to +8%.  The biases are staged in shared
// memory once per block (bias_floats): read from that L2 at each pass's
// start, they held both warpgroups' first product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float RGB_PAD = 0.001f;   // the mip arch's widened sigmoid: s (1 + 2 p) - p

constexpr int ROWS = 64;                  // rows (sample points) of one warpgroup tile
constexpr int TILE_K = 64;                // weight rows per tile: one 128-byte swizzle atom
constexpr int KB_BYTES = ROWS * 128;      // one 64-column block of an activation buffer
constexpr int CONSUMERS = 2;              // consumer warpgroups per block
// + a producer warpgroup: setmaxnreg moves registers only within the block
// (an increase waits for registers the block released), so the consumers'
// 64 extra registers a thread (168 -> 232) come from a whole warpgroup
// dropping from 168 to 40.  One lane of it issues the copies, its other
// three warps encode.
constexpr int THREADS = CONSUMERS * 128 + 128;
constexpr int EMPTY_ARRIVALS = CONSUMERS * 4;   // lane 0 of every consumer warp
constexpr int MAX_PASSES = 24;
constexpr int MAX_TILES = 128;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_BUDGET = 232448;       // dynamic shared memory a block may use
constexpr int SMALL_FLOATS = 576;         // per-warpgroup small arrays (see the kernel)
constexpr int ENCODERS = 96;              // producer-warpgroup threads that encode (warps 1-3)

// pass kinds: what the epilogue does with a product (P_LIN: bf16 without
// ReLU, the mip arch's bottleneck; a plan holds it only for that arch)
enum PassKind { P_RELU = 0, P_DENS = 1, P_RGB1 = 2, P_RGB2 = 3, P_LIN = 4 };

struct Pass {
  int kind, n, b_off;   // product width, bias offset
  int first, n_tiles;   // its tiles in Plan::tiles
  int n_act;            // the first n_act tiles multiply the activations, the rest the encoding
};

struct Tile {
  int off;     // bf16 element offset in the tile image
  int bytes;   // n * 128
  int steps;   // k16 steps present (rows / 16)
  int kb;      // 64-column block of the source buffer
};

struct Plan {
  Pass passes[MAX_PASSES];
  Tile tiles[MAX_TILES];
  int n_passes, n_tiles;
  int dir_off;              // element offset of rgb1's direction rows (dir_dim x 128, row-major)
  int act_kb, enc_kb;       // 64-column blocks of the activation / encoding buffers
  int stage_bytes, stages;  // ring slot size and count
  int last_enc_pass;        // after it, the encoding buffer may be refilled
  int n_bias;               // floats of the biases the block stages (bias_floats)
  // shared-memory layout, bytes from the 1024-aligned base
  int act, enc, small, bias, bars, ring, total;
};

// The biases the passes read, [0, max(b_off + n)) of the flat buffer, in
// whole float4: the block's copy in shared memory, made with 16-byte loads.
inline int bias_floats(const Plan& p) {
  int n = 0;
  for (int i = 0; i < p.n_passes; ++i)
    if (p.passes[i].b_off + p.passes[i].n > n) n = p.passes[i].b_off + p.passes[i].n;
  return (n + 3) & ~3;
}

// ip: n_passes, n_tiles, dir_off, act_kb, enc_kb, stage_bytes, then
// (kind, n, b_off, first, n_tiles, n_act) per pass, then (off, bytes,
// steps, kb) per tile.  Checks the plan and lays out shared memory.
inline cudaError_t parse_plan(const int* ip, Plan* p) {
  p->n_passes = ip[0];
  p->n_tiles = ip[1];
  p->dir_off = ip[2];
  p->act_kb = ip[3];
  p->enc_kb = ip[4];
  p->stage_bytes = ip[5];
  if (p->n_passes < 1 || p->n_passes > MAX_PASSES || p->n_tiles < 1 || p->n_tiles > MAX_TILES ||
      p->act_kb < 2 || p->act_kb > 4 || p->enc_kb < 1 || p->enc_kb > 2 ||
      p->stage_bytes < 1024 || p->stage_bytes > 256 * 128 || p->stage_bytes % 1024)
    return cudaErrorInvalidValue;
  const int* q = ip + 6;
  int next = 0;
  for (int i = 0; i < p->n_passes; ++i, q += 6) {
    p->passes[i] = Pass{q[0], q[1], q[2], q[3], q[4], q[5]};
    const Pass& s = p->passes[i];
    const bool width_ok = (s.kind == P_RELU || s.kind == P_LIN)
                              ? (s.n % 16 == 0 && s.n >= 16 && s.n <= 256)
                        : s.kind == P_RGB1 ? s.n == 128
                        : (s.kind == P_DENS || s.kind == P_RGB2) ? s.n == 16 : false;
    if (!width_ok || s.first != next || s.n_tiles < 1 || s.n_act < 0 || s.n_act > s.n_tiles)
      return cudaErrorInvalidValue;
    next += s.n_tiles;
  }
  if (next != p->n_tiles) return cudaErrorInvalidValue;
  p->last_enc_pass = -1;
  for (int i = 0; i < p->n_passes; ++i)
    if (p->passes[i].n_act < p->passes[i].n_tiles) p->last_enc_pass = i;
  if (p->last_enc_pass < 0) return cudaErrorInvalidValue;
  for (int i = 0; i < p->n_tiles; ++i, q += 4) {
    p->tiles[i] = Tile{q[0], q[1], q[2], q[3]};
    const Tile& t = p->tiles[i];
    if (t.off % 64 || t.bytes % 1024 || t.bytes > p->stage_bytes || t.steps < 1 ||
        t.steps > TILE_K / 16 || t.kb < 0 || t.kb >= p->act_kb)
      return cudaErrorInvalidValue;
  }
  int off = 0;
  p->act = off;
  off += CONSUMERS * p->act_kb * KB_BYTES;
  p->enc = off;
  off += CONSUMERS * p->enc_kb * KB_BYTES;
  p->small = off;
  off += CONSUMERS * SMALL_FLOATS * 4;
  p->n_bias = bias_floats(*p);
  p->bias = off;
  off += p->n_bias * 4;
  p->bars = off;
  off += 2 * MAX_STAGES * 8 + 2 * CONSUMERS * 8;   // ring full/empty, encoding full/empty
  off = (off + 1023) & ~1023;
  p->ring = off;
  p->stages = (SMEM_BUDGET - 1024 - off) / p->stage_bytes;
  if (p->stages > MAX_STAGES) p->stages = MAX_STAGES;
  if (p->stages < 2) return cudaErrorInvalidValue;
  p->total = off + p->stages * p->stage_bytes + 1024;   // + slack to align the base
  return cudaSuccess;
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// arrive from lane 0 only: predicated inside the asm, so the compiler sees
// no divergent path between wgmmas in flight (it would serialize them)
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// wait until the barrier's phase with this parity has completed (the spin
// stays inside the asm for the same reason)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes from device memory to shared memory, completing on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes from shared memory to device memory as one bulk-copy group, issued
// by the thread whose ``on`` is set (predicated inside the asm, so the
// compiler sees no divergent branch); the source must not change until the
// same thread's bulk_wait_read returns
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"l"(dst),
      "r"(src), "r"(bytes), "r"((int)on)
      : "memory");
}

// the calling thread's bulk stores have read their shared-memory sources
__device__ __forceinline__ void bulk_wait_read(bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group.read 0;\n}\n" ::"r"((int)on)
      : "memory");
}

// the calling thread's bulk stores are complete (their writes performed)
__device__ __forceinline__ void bulk_wait_all(bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group 0;\n}\n" ::"r"((int)on)
      : "memory");
}

// ---- clusters ---------------------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster: arrive, then wait for all the others (the
// blocks' mbarrier inits before, and their remote accesses after, or the
// reverse at the end)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// lane l < n of the calling warp arrives on the barrier at the same offset
// in block l of the cluster (predicated inside the asm, as mbar_arrive_lane0)
__device__ __forceinline__ void mbar_arrive_cluster_lanes(uint32_t bar, int lane, int n) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\nsetp.lt.s32 p, %1, %2;\n"
      "@p mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(lane), "r"(n)
      : "memory");
}

// bytes from device memory to the same shared-memory offset of every block
// in ``mask`` of the cluster, each completing on its barrier at ``bar``'s
// offset
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, int bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// generic-proxy shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of one consumer warpgroup (ids 1.., id 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 tiles from registers to shared memory: lane l gives the
// address of row l % 8 of tile l / 8, and r_i holds its two elements of
// row l / 4 of tile i (the accumulator fragment's layout)
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// the inverse of stmatrix_x4: the same four 8x8 tiles, from the same lane
// addresses, into the same registers
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// bf16x2 of (relu(a), relu(b)), a in the low half: one instruction
__device__ __forceinline__ uint32_t relu_bf16x2(float a, float b) {
  uint32_t v;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(b), "f"(a));
  return v;
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// descriptor of a K-major, 128-byte-swizzled operand at a shared address:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused (1).  A
// k16 step inside the 64-wide atom adds 32 bytes to the address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// byte offset of element (row, col) of a swizzled activation buffer
__device__ __forceinline__ int sw128(int row, int col) {
  return (col >> 6) * KB_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// descriptor of an MN-major, 128-byte-swizzled operand: rows of 128 bytes
// hold 64 consecutive M (or N) values of one k, 8 k-rows make a 1024-byte
// swizzle atom (SBO 1024 to the next 8 k), and the next 64 M (N) values sit
// ``mn_stride`` bytes on (LBO).  A k16 step adds 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr, uint32_t mn_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, f32 in registers) = or += A (64 x 16) * B (16 x N), both
// bf16 in shared memory.  Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4j], d[4j+1] on the first row, d[4j+2], d[4j+3] on the second.
// TRANS_A / TRANS_B = 1 reads that operand MN-major (desc_sw128_mn), 0
// K-major.
template <int N, int TRANS_A = 0, int TRANS_B = TRANS_A>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<16, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// ---- the layer chain ------------------------------------------------------

// One consumer warpgroup's view: its buffers and its thread.
struct Wg {
  int g, tid, warp, lane;
  uint32_t act, enc;              // shared addresses of its activation and encoding buffers
  uint32_t enc_full, enc_empty;   // its encoding buffer's mbarriers
  float *dist, *dens, *rgb, *dirpart, *dext, *red;
};

struct Ring {
  uint32_t base, full, empty;   // shared addresses: slot 0, full[0], empty[0]
  int stages, stage_bytes;
};

// The encoding buffer of a warpgroup is written by the producer
// warpgroup's encoder threads (ENCODERS arrivals on enc_full) and freed by
// the warpgroup once its last product reading it is done (one arrival per
// warp on enc_empty).  k counts the warpgroup's chunks.
__device__ __forceinline__ void wait_encoding(const Wg& w, uint32_t k) {
  mbar_wait(w.enc_full, k & 1);
}

__device__ __forceinline__ void release(const Ring& r, uint32_t q, int lane) {
  mbar_arrive_lane0(r.empty + 8 * (q % r.stages), lane);
}

__device__ __forceinline__ void wait_full(const Ring& r, uint32_t q) {
  mbar_wait(r.full + 8 * (q % r.stages), (q / r.stages) & 1);
}

// The tiles of one pass: wait for each, issue its k16 steps, release the
// previous tile once its products are done.  NSL slices of width NT cover
// the product's n columns (nsl of them are used).  ``accumulate``: add to
// the accumulators' values (the bias) instead of starting from zero.
template <int NT, int NSL>
__device__ __forceinline__ void product(float (&acc)[NSL][NT / 2], int nsl, const Plan& plan,
                                        const Pass& ps, const Wg& w, const Ring& r, uint32_t& q,
                                        bool accumulate) {
  wgmma_fence();
  for (int t = 0; t < ps.n_tiles; ++t) {
    const Tile& tl = plan.tiles[ps.first + t];
    wait_full(r, q);
    const uint32_t a0 = (t < ps.n_act ? w.act : w.enc) + tl.kb * KB_BYTES;
    const uint32_t b0 = r.base + (q % r.stages) * r.stage_bytes;
    for (int ks = 0; ks < tl.steps; ++ks) {
      const uint64_t da = desc_sw128(a0 + ks * 32);
      const uint64_t db = desc_sw128(b0 + ks * 32);
#pragma unroll
      for (int s = 0; s < NSL; ++s)
        if (NSL == 1 || s < nsl)
          Wgmma<NT>::mma(acc[s], da, db + (uint64_t)(s * NT * 8), accumulate || (t | ks) != 0);
    }
    wgmma_commit();
    if (t > 0) {
      wgmma_wait<1>();
      release(r, q - 1, w.lane);
    }
    ++q;
  }
  wgmma_wait<0>();
  release(r, q - 1, w.lane);
}

// The accumulators of a ReLU product start at its bias (with ADD: at
// add + bias, rgb1's direction head), so its epilogue loads nothing; bias
// is the block's copy in shared memory
template <int NT, int NSL, bool ADD>
__device__ __forceinline__ void init_bias(float (&acc)[NSL][NT / 2], int nsl,
                                          const float* __restrict__ bias, const float* add,
                                          const Wg& w) {
  const int c_lane = 2 * (w.lane & 3);
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    if (NSL == 1 || s < nsl) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = s * NT + 8 * j + c_lane;
        float2 b = *reinterpret_cast<const float2*>(bias + col);
        if (ADD) {
          b.x = add[col] + b.x;
          b.y = add[col + 1] + b.y;
        }
        acc[s][4 * j] = b.x;
        acc[s][4 * j + 1] = b.y;
        acc[s][4 * j + 2] = b.x;
        acc[s][4 * j + 3] = b.y;
      }
    }
  }
}

// bf16x2 of (a, b), a in the low half
__device__ __forceinline__ uint32_t plain_bf16x2(float a, float b) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(b), "f"(a));
  return v;
}

// relu(acc) rounded to bf16, into the same rows of the activation buffer,
// four 8x8 tiles per stmatrix: rows 0-7 and 8-15 of this warp's 16 rows
// for two neighbouring 8-column blocks.  LIN: without the ReLU where
// ``relu`` is false (the mip arch's bottleneck)
template <int NT, int NSL, bool LIN = false>
__device__ __forceinline__ void epi_relu(const float (&acc)[NSL][NT / 2], int nsl, const Wg& w,
                                         bool relu = true) {
  // no branch on ``relu`` beside the accumulators: a floor of 0 or -inf
  const float lo = relu ? 0.0f : __int_as_float(0xff800000);
  auto cvt = [lo](float a, float b) {
    if constexpr (LIN)
      return plain_bf16x2(fmaxf(a, lo), fmaxf(b, lo));
    else
      return relu_bf16x2(a, b);
  };
  const int tile = w.lane >> 3;
  const int row = 16 * w.warp + (w.lane & 7) + 8 * (tile & 1);
  const uint32_t row_addr = w.act + row * 128;
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    if (NSL == 1 || s < nsl) {
#pragma unroll
      for (int j = 0; j < NT / 8; j += 2) {
        const int chunk = s * NT / 8 + j + (tile >> 1);   // 16-byte column chunk
        const uint32_t addr =
            row_addr + (chunk >> 3) * KB_BYTES + (((chunk & 7) ^ (row & 7)) << 4);
        stmatrix_x4(addr, cvt(acc[s][4 * j], acc[s][4 * j + 1]),
                    cvt(acc[s][4 * j + 2], acc[s][4 * j + 3]),
                    cvt(acc[s][4 * j + 4], acc[s][4 * j + 5]),
                    cvt(acc[s][4 * j + 6], acc[s][4 * j + 7]));
      }
    }
  }
}

// The density and rgb epilogues read the accumulators in every thread and
// store from some: an accumulator read inside a divergent branch makes ptxas
// serialize the wgmmas.

// the density column (column 0 of the 16-wide density tile): softplus or relu
__device__ __forceinline__ void epi_dens(const float (&acc)[1][8], const float* __restrict__ bias,
                                         int softplus, const Wg& w) {
  const int r0 = 16 * w.warp + (w.lane >> 2);
  const float b = bias[0];
  float v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float x = acc[0][2 * h] + b;
    v[h] = softplus ? fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) : fmaxf(x, 0.0f);
  }
  if ((w.lane & 3) == 0) {
    w.dens[r0] = v[0];
    w.dens[r0 + 8] = v[1];
  }
}

// sigmoid of columns 0..2 of the 16-wide rgb2 product; MIP: widened to
// 1.002 s - 0.001 (each operation rounded once)
template <bool MIP = false>
__device__ __forceinline__ void epi_rgb(const float (&acc)[1][8], const float* __restrict__ bias,
                                        const Wg& w) {
  const int c0 = 2 * (w.lane & 3);
  const int r0 = 16 * w.warp + (w.lane >> 2);
  const float b0 = bias[c0 & 7], b1 = bias[(c0 + 1) & 7];
  float v[4] = {1.0f / (1.0f + expf(-(acc[0][0] + b0))), 1.0f / (1.0f + expf(-(acc[0][1] + b1))),
                1.0f / (1.0f + expf(-(acc[0][2] + b0))), 1.0f / (1.0f + expf(-(acc[0][3] + b1)))};
  if constexpr (MIP) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __fsub_rn(__fmul_rn(v[e], 1.0f + 2.0f * RGB_PAD), RGB_PAD);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (c0 + e < 3) {
      w.rgb[r0 * 3 + c0 + e] = v[e];
      w.rgb[(r0 + 8) * 3 + c0 + e] = v[2 + e];
    }
  }
}

// The whole layer chain of one 64-row chunk, the warpgroup's k-th (its
// encoding arrives in w.enc, the direction head is in w.dirpart, B is the
// block's copy of the biases in shared memory): leaves
// the density in w.dens and the colours in w.rgb, published to the
// warpgroup.  WIDE: every ReLU product
// is 256 wide and runs as one m64n256k16 per k16 step; otherwise as
// 16-wide slices, any width that is a multiple of 16.
//
// STASH: thread 0 also copies the chunk's encoding and every ReLU / rgb1
// output, as the swizzled buffer image each product read, to ``rec`` in
// device memory (bulk copies): the encoding's enc_kb blocks first, then
// output j (in pass order) at block enc_kb + j act_kb, ceil(n / 64) blocks
// of it.  Each copy is issued once the rows are published and waited for
// (its reads) after the next product, before an epilogue overwrites them.
//
// MIP: the mip arch's chain, whose density/feature head's feature pass is
// P_LIN (stored without ReLU, stashed like the ReLU outputs) and whose rgb
// head is widened (epi_rgb<true>).
template <bool WIDE, bool STASH = false, bool MIP = false>
__device__ __forceinline__ void mlp_chunk(const Plan& plan, const float* __restrict__ B,
                                          int softplus, const Wg& w, const Ring& r, uint32_t& q,
                                          uint32_t k, __nv_bfloat16* rec = nullptr) {
  const bool lead = w.tid == 0;
  wait_encoding(w, k);
  if constexpr (STASH) bulk_store(rec, w.enc, plan.enc_kb * KB_BYTES, lead);
  int slot = 0;
  for (int p = 0; p < plan.n_passes; ++p) {
    const Pass& ps = plan.passes[p];
    if (ps.kind == P_RELU || (MIP && ps.kind == P_LIN)) {
      const bool relu = ps.kind == P_RELU;
      if constexpr (WIDE) {
        float acc[1][128];
        init_bias<256, 1, false>(acc, 1, B + ps.b_off, nullptr, w);
        product<256, 1>(acc, 1, plan, ps, w, r, q, true);
        if constexpr (STASH) bulk_wait_read(lead);
        wg_sync(w.g);
        epi_relu<256, 1, MIP>(acc, 1, w, relu);
      } else {
        float acc[16][8];
        init_bias<16, 16, false>(acc, ps.n / 16, B + ps.b_off, nullptr, w);
        product<16, 16>(acc, ps.n / 16, plan, ps, w, r, q, true);
        if constexpr (STASH) bulk_wait_read(lead);
        wg_sync(w.g);
        epi_relu<16, 16, MIP>(acc, ps.n / 16, w, relu);
      }
    } else if (ps.kind == P_RGB1) {
      float acc[1][64];
      init_bias<128, 1, true>(acc, 1, B + ps.b_off, w.dirpart, w);
      product<128, 1>(acc, 1, plan, ps, w, r, q, true);
      if constexpr (STASH) bulk_wait_read(lead);
      wg_sync(w.g);
      epi_relu<128, 1>(acc, 1, w);
    } else {
      float acc[1][8];
      product<16, 1>(acc, 1, plan, ps, w, r, q, false);
      if constexpr (STASH) bulk_wait_read(lead);
      wg_sync(w.g);
      if (ps.kind == P_DENS)
        epi_dens(acc, B + ps.b_off, softplus, w);
      else
        epi_rgb<MIP>(acc, B + ps.b_off, w);
    }
    if (p == plan.last_enc_pass) mbar_arrive_lane0(w.enc_empty, w.lane);
    fence_proxy_async();
    wg_sync(w.g);
    if constexpr (STASH) {
      if (ps.kind == P_RELU || ps.kind == P_RGB1 || (MIP && ps.kind == P_LIN)) {
        bulk_store(rec + (size_t)(plan.enc_kb + slot * plan.act_kb) * (KB_BYTES / 2), w.act,
                   ((ps.n + 63) / 64) * KB_BYTES, lead);
        ++slot;
      }
    }
  }
}

// a warpgroup with no ray left still releases every tile of a chunk
__device__ __forceinline__ void skip_chunk(const Plan& plan, const Wg& w, const Ring& r,
                                           uint32_t& q) {
  for (int t = 0; t < plan.n_tiles; ++t, ++q) {
    wait_full(r, q);
    release(r, q, w.lane);
  }
}

// The producer: one lane streams the plan's tiles `rounds` times.
__device__ __forceinline__ void produce(const Plan& plan, const __nv_bfloat16* __restrict__ img,
                                        const Ring& r, int rounds) {
  uint32_t q = 0;
  for (int k = 0; k < rounds; ++k) {
    for (int t = 0; t < plan.n_tiles; ++t, ++q) {
      const uint32_t slot = q % r.stages;
      mbar_wait(r.empty + 8 * slot, ((q / r.stages) & 1) ^ 1);
      const Tile& tl = plan.tiles[t];
      mbar_expect_tx(r.full + 8 * slot, tl.bytes);
      bulk_copy(r.base + slot * r.stage_bytes, img + tl.off, tl.bytes, r.full + 8 * slot);
    }
  }
}

}  // namespace sm90
