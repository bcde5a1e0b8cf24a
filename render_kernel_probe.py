#!/usr/bin/env python3
"""What bounds the render kernel (K1) on the card.

    python3 render_kernel_probe.py

Times K1 on an 800x800 frame at 256 samples (640,000 seeded rays through
the committed synth800 checkpoint) beside patched copies of its source,
each a copy of kernels/csrc/ with one edit, built under
build/render_probe/<variant>/ (git-ignored):

- base: the kernel as it is;
- bias_from_l2: the layer chain reads its biases from device memory
  instead of the block's copy in shared memory (the same arithmetic: its
  frame must equal base's bit for bit);
- no_weight_copies: the producer completes each ring slot without copying
  a tile (no weight traffic from L2; the products read stale tiles);
- no_relu_epilogue: the 256-wide ReLU products skip their epilogue (an
  empty asm still takes every accumulator, so ptxas keeps the products);
- no_sin: the encoder writes the phases instead of their sines;
- timeline: clock64() stamps, on block 0, around each product and
  epilogue of one chunk (the 11th ray slot's first chunk) of both
  consumer warpgroups, in SM cycles, and when each pass's first tile may
  be issued.

The variants compute wrong images: they only time.  Then the no-PE
checkpoint's sensitivity, on the rays of tests/test_torch_gpu.py's no-PE
case: the kernel's weights against the plain version in float32, float64
and with its products summed on the tensor cores in bf16.

Prints the card's name and power limit, then one JSON line per variant.
Each variant runs in a process of its own.  Needs a CUDA card.
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "sfm_nerf_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "render_probe")
CKPTS = os.path.join(REPO, "Phase2", "checkpoints")
REPS = 3

# the timeline's stamp: thread 0 of warpgroup g on block 0 stores the SM
# clock into slot s of g_trace[g] while ``chunk`` (the warpgroup's chunk
# count) is TRACE_CHUNK, the 11th ray slot's first chunk; predicated inside
# the asm, with no load and no branch, so it costs an issue slot
_TRACE = r"""namespace sm90 {
__device__ long long g_trace[2][64];
constexpr uint32_t TRACE_CHUNK = 40;
__device__ __forceinline__ void trace_stamp(int g, int s, uint32_t chunk, int tid) {
  asm volatile("{\n.reg .pred p;\n.reg .u64 c;\nsetp.eq.u32 p, %1, 0;\n"
               "mov.u64 c, %%clock64;\n@p st.u64 [%0], c;\n}\n"
               :: "l"(&g_trace[g][s]), "r"(blockIdx.x | (uint32_t)tid | (chunk ^ TRACE_CHUNK))
               : "memory");
}
"""
# stamp slots of a warpgroup: pass p's start 3p, its product's end 3p + 1
# (drained), its epilogue's end 3p + 2, its first tile ready to issue 39 + p
# (after the ring's wait); the chunk's start (before its distances) 60, the
# compositing's start 62 and end 63
PATCHES = {
    "base": [],
    "bias_from_l2": [
        ("fused_render.cu", "sm90::mlp_chunk<WIDE, true, MIP>(plan, bias,",
         "sm90::mlp_chunk<WIDE, true, MIP>(plan, B,"),
        ("fused_render.cu", "sm90::mlp_chunk<WIDE, false, MIP>(plan, bias,",
         "sm90::mlp_chunk<WIDE, false, MIP>(plan, B,")],
    "no_weight_copies": [(
        "sm90_mlp.cuh",
        "      mbar_expect_tx(r.full + 8 * slot, tl.bytes);\n"
        "      bulk_copy(r.base + slot * r.stage_bytes, img + tl.off, tl.bytes, r.full + 8 * slot);\n",
        "      mbar_arrive(r.full + 8 * slot);\n")],
    "no_relu_epilogue": [(
        "sm90_mlp.cuh", "        epi_relu<256, 1, MIP>(acc, 1, w, relu);\n",
        "#pragma unroll\n"
        "        for (int i = 0; i < 128; ++i) asm volatile(\"\" ::\"f\"(acc[0][i]));\n")],
    "no_sin": [(
        "fused_render.cu",
        "      put(row, c, sinf(u0));\n"
        "      put(row, c + 1, sinf(u1));\n"
        "      put(row, c + 2, sinf(u2));\n"
        "      put(row, c + 3, sinf(__fadd_rn(u0, P.half_pi)));\n"
        "      put(row, c + 4, sinf(__fadd_rn(u1, P.half_pi)));\n"
        "      put(row, c + 5, sinf(__fadd_rn(u2, P.half_pi)));\n",
        "      put(row, c, u0);\n"
        "      put(row, c + 1, u1);\n"
        "      put(row, c + 2, u2);\n"
        "      put(row, c + 3, __fadd_rn(u0, P.half_pi));\n"
        "      put(row, c + 4, __fadd_rn(u1, P.half_pi));\n"
        "      put(row, c + 5, __fadd_rn(u2, P.half_pi));\n")],
    "timeline": [
        ("sm90_mlp.cuh", "namespace sm90 {\n", _TRACE),
        ("sm90_mlp.cuh",
         "  for (int p = 0; p < plan.n_passes; ++p) {\n    const Pass& ps = plan.passes[p];\n",
         "  for (int p = 0; p < plan.n_passes; ++p) {\n    const Pass& ps = plan.passes[p];\n"
         "    trace_stamp(w.g, 3 * p, k, w.tid);\n"),
        ("sm90_mlp.cuh", "    const Tile& tl = plan.tiles[ps.first + t];\n    wait_full(r, q);\n",
         "    const Tile& tl = plan.tiles[ps.first + t];\n    wait_full(r, q);\n"
         "    trace_stamp(w.g, 39 + (int)(&ps - plan.passes), t == 0 ? q / plan.n_tiles : ~0u,"
         " w.tid);\n"),
        ("sm90_mlp.cuh", "  wgmma_wait<0>();\n  release(r, q - 1, w.lane);\n}\n",
         "  wgmma_wait<0>();\n  release(r, q - 1, w.lane);\n"
         "  trace_stamp(w.g, 3 * (int)(&ps - plan.passes) + 1, (q - 1) / plan.n_tiles, w.tid);\n"
         "}\n"),
        ("sm90_mlp.cuh",
         "    if (p == plan.last_enc_pass) mbar_arrive_lane0(w.enc_empty, w.lane);\n",
         "    trace_stamp(w.g, 3 * p + 2, k, w.tid);\n"
         "    if (p == plan.last_enc_pass) mbar_arrive_lane0(w.enc_empty, w.lane);\n"),
        ("fused_render.cu", "        chunk_dists<MIP>(P, w, z_ray, S, c0, norm);\n",
         "        sm90::trace_stamp(g, 60, k, w.tid);\n"
         "        chunk_dists<MIP>(P, w, z_ray, S, c0, norm);\n"),
        ("fused_render.cu",
         "        composite_chunk<EMIT_WEIGHTS>(P, w, S, c0, w_ray, T, acc_r, acc_g, acc_b);\n",
         "        sm90::trace_stamp(g, 62, k - 1, w.tid);\n"
         "        composite_chunk<EMIT_WEIGHTS>(P, w, S, c0, w_ray, T, acc_r, acc_g, acc_b);\n"
         "        sm90::trace_stamp(g, 63, k - 1, w.tid);\n"),
        ("fused_render.cu", "const char* sfm_cuda_error_string(int code) {",
         "int sfm_trace(long long* out) {\n"
         "  return cudaMemcpyFromSymbol(out, sm90::g_trace, sizeof(sm90::g_trace));\n}\n\n"
         "const char* sfm_cuda_error_string(int code) {"),
    ],
}


def apply_variant(name, dest):
    """Copy csrc/ to ``dest`` with the variant's edits; raises unless each
    edit's text occurs exactly once in its file."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(CSRC, dest, ignore=shutil.ignore_patterns("_build"))
    for f, old, new in PATCHES[name]:
        path = os.path.join(dest, f)
        with open(path) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: edit occurs {src.count(old)} times in {f}, "
                               f"not once: {old[:60]!r}")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    return dest


def variant_dir(name):
    """build/render_probe/<name>/: csrc/ with the variant's edits."""
    return apply_variant(name, os.path.join(OUT, name))


def rays(n, s, seed, dev):
    """Rays and sorted depths as tests/test_torch_gpu.py draws them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 4.0
    d = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), -1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (o, d, z)]


def packed_checkpoint(name):
    import torch
    from sfm_nerf_tpu_torch.kernels import fused_render as fr
    from sfm_nerf_tpu_torch.models.convert import params_from_jax
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt

    params, _ = ckpt.load_params_untyped(os.path.join(CKPTS, name, "final_model.ckpt.npz"))
    mcfg = ckpt.infer_model_config(params)
    return fr.pack_nerf_params(params_from_jax(params, mcfg, "cuda"), mcfg, torch.bfloat16)


def timeline_parts(t, passes):
    """The timeline's stamps (2, 64) as cycles per part of each warpgroup's
    chunk, from warpgroup 0's chunk start: per pass its start, the wait
    until its first tile may be issued (the ring's wait included; a
    source without the stamp reads 0), product (from the pass's start to
    its products drained, the waits included), epilogue and the barrier
    after it; per warpgroup the sums of the wide (256-column) products, the
    narrow ones, the first-tile waits, the epilogues and barriers, the
    distances and the compositing."""
    t0 = int(t[0, 60])
    out = {}
    for g in range(2):
        rows, sums = [], {"wide_products": 0, "narrow_products": 0, "issue_waits": 0,
                          "epilogues": 0, "barriers": 0}
        for p, (kind, n) in enumerate(passes):
            a, b, c = (int(x) for x in t[g, 3 * p:3 * p + 3])
            nxt = int(t[g, 3 * p + 3]) if p + 1 < len(passes) else int(t[g, 62])
            first = int(t[g, 39 + p]) - a if t[g, 39 + p] else 0
            rows.append({"kind": kind, "n": n, "start": a - t0, "issue_wait": first,
                         "product": b - a, "epilogue": c - b, "barrier": nxt - c})
            sums["issue_waits"] += first
            sums["wide_products" if n == 256 else "narrow_products"] += b - a
            sums["epilogues"] += c - b
            sums["barriers"] += nxt - c
        out[f"warpgroup_{g}"] = {
            "chunk_start": int(t[g, 60]) - t0, "dists": int(t[g, 0] - t[g, 60]),
            "layer_chain": int(t[g, 62] - t[g, 0]), "composite": int(t[g, 63] - t[g, 62]),
            "chunk": int(t[g, 63] - t[g, 60]), **sums, "passes": rows}
    return out


def run_variant(name):
    import numpy as np
    import torch
    from sfm_nerf_tpu_torch.kernels import _build

    _build.CSRC = os.path.join(OUT, name)
    _build.BUILD_DIR = os.path.join(_build.CSRC, "_build")
    from sfm_nerf_tpu_torch.config import RenderConfig
    from sfm_nerf_tpu_torch.kernels import fused_render as fr

    packed = packed_checkpoint("synth800")
    o, d, z = rays(640000, 256, 1, "cuda")
    rcfg = RenderConfig(n_sample=256)
    rgb = fr.fused_render_rays(packed, o, d, z, rcfg)
    torch.save(rgb.cpu(), os.path.join(OUT, name, "rgb.pt"))
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fr.fused_render_rays(packed, o, d, z, rcfg)
    e1.record()
    torch.cuda.synchronize()
    out = {"variant": name, "rays": 640000, "samples": 256, "ms": e0.elapsed_time(e1) / REPS}
    if name == "timeline":
        import ctypes

        lib = _build.load("fused_render")
        buf = (ctypes.c_longlong * 128)()
        lib.sfm_trace.argtypes = [ctypes.c_void_p]
        if lib.sfm_trace(ctypes.cast(buf, ctypes.c_void_p)) != 0:
            raise RuntimeError("timeline: cudaMemcpyFromSymbol failed")
        t = np.array(list(buf), dtype=np.int64).reshape(2, 64)
        plan = fr.render_plan(packed)
        out.update(timeline_parts(t, [(p.kind, p.n) for p in plan.passes]))
    print(json.dumps(out), flush=True)


def no_pe_sensitivity():
    """The no-PE case of tests/test_torch_gpu.py: how far the kernel's
    weights are from the plain version's, and how far the plain version
    itself moves in float64 and with bf16 tensor-core products."""
    import torch
    from sfm_nerf_tpu_torch.config import RenderConfig
    from sfm_nerf_tpu_torch.kernels import fused_render as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    packed = packed_checkpoint("synth800_nope")
    o, d, z = rays(1024, 128, 128, "cuda")
    rcfg = RenderConfig(n_sample=128)
    w = fr.fused_render_rays_weights(packed, o, d, z, rcfg)[1]
    wr = fr.fused_render_rays_reference(packed, o, d, z, rcfg, emit_weights=True)[1]
    w64 = fr.fused_render_rays_reference(packed, o.double(), d.double(), z.double(), rcfg,
                                         emit_weights=True)[1]
    wtc = fr.fused_render_rays_reference(packed, o, d, z, rcfg, emit_weights=True,
                                         bf16_products=True)[1]
    e = (w - wr).abs()
    at = divmod(int(e.argmax()), e.shape[1])
    print(json.dumps({
        "no_pe": {"rays": 1024, "samples": 128, "kernel_vs_plain_max": e.max().item(),
                  "above_1e-3": int((e > 1e-3).sum()), "above_1e-2": int((e > 1e-2).sum()),
                  "at": at, "kernel_w": w[at].item(), "plain_w": wr[at].item(),
                  "plain_f64_w": w64[at].item(),
                  "plain_f32_vs_f64_max": (wr.double() - w64).abs().max().item(),
                  "plain_f32_vs_bf16_products_max": (wr - wtc).abs().max().item()}}),
          flush=True)


def main():
    sys.path.insert(0, REPO)
    if len(sys.argv) > 1:
        if sys.argv[1] == "no_pe":
            no_pe_sensitivity()
        else:
            run_variant(sys.argv[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("render_kernel_probe: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for name in PATCHES:
        variant_dir(name)
    failed = 0
    for name in [*PATCHES, "base", "no_pe"]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), name],
                           capture_output=True, text=True, timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode:
            failed += 1
            print(f"{name}: exit {r.returncode}\n{r.stderr[-2000:]}", file=sys.stderr)
    frames = [os.path.join(OUT, n, "rgb.pt") for n in ("base", "bias_from_l2")]
    if all(os.path.exists(f) for f in frames):
        a, b = (torch.load(f) for f in frames)
        same = bool(torch.equal(a, b))
        print(json.dumps({"bias_from_l2_vs_base": {"bit_equal": same,
                                                   "max_abs": (a - b).abs().max().item()}}),
              flush=True)
        failed += not same
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
