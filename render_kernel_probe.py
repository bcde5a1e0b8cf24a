#!/usr/bin/env python3
"""What bounds the render kernel (K1) on the card.

    python3 render_kernel_probe.py

Times K1 on an 800x800 frame at 256 samples (640,000 seeded rays through
the committed synth800 checkpoint) beside patched copies of its source,
each a copy of kernels/csrc/ with one edit, built under
build/render_probe/<variant>/ (git-ignored):

- base: the kernel as it is;
- no_weight_copies: the producer completes each ring slot without copying
  a tile (no weight traffic from L2; the products read stale tiles);
- no_relu_epilogue: the 256-wide ReLU products skip their epilogue;
- no_sin: the encoder writes the phases instead of their sines;
- timeline: clock64() stamps, on block 0, around each product and
  epilogue of one chunk (the 11th ray slot's first chunk) of both
  consumer warpgroups, in SM cycles.

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

_STAMP = ("  if (blockIdx.x == 0 && w.tid == 0 && g_trace_on[w.g]) "
          "g_trace[w.g][%s] = clock64();\n")
_KSTAMP = ("        if (blockIdx.x == 0 && w.tid == 0 && sm90::g_trace_on[g]) "
           "sm90::g_trace[g][%d] = clock64();\n")
PATCHES = {
    "base": [],
    "no_weight_copies": [(
        "sm90_mlp.cuh",
        "      mbar_expect_tx(r.full + 8 * slot, tl.bytes);\n"
        "      bulk_copy(r.base + slot * r.stage_bytes, img + tl.off, tl.bytes, r.full + 8 * slot);\n",
        "      mbar_arrive(r.full + 8 * slot);\n")],
    "no_relu_epilogue": [("sm90_mlp.cuh", "        epi_relu<256, 1>(acc, 1, w);\n", "")],
    "no_sin": [("fused_render.cu", "sinf(", "(")],
    "timeline": [
        ("sm90_mlp.cuh", "namespace sm90 {\n",
         "namespace sm90 {\n__device__ long long g_trace[2][64];\n__device__ int g_trace_on[2];\n"),
        ("sm90_mlp.cuh",
         "  for (int p = 0; p < plan.n_passes; ++p) {\n    const Pass& ps = plan.passes[p];\n",
         "  for (int p = 0; p < plan.n_passes; ++p) {\n    const Pass& ps = plan.passes[p];\n"
         + _STAMP % "3 * p"),
        ("sm90_mlp.cuh",
         "        product<256, 1>(acc, 1, plan, ps, w, r, q, true);\n        wg_sync(w.g);\n",
         "        product<256, 1>(acc, 1, plan, ps, w, r, q, true);\n" + _STAMP % "3 * p + 1"
         + "        wg_sync(w.g);\n"),
        ("sm90_mlp.cuh", "    fence_proxy_async();\n    wg_sync(w.g);\n  }\n}\n",
         _STAMP % "3 * p + 2" + "    fence_proxy_async();\n    wg_sync(w.g);\n  }\n}\n"),
        ("fused_render.cu", "        chunk_dists(P, w, z_ray, S, c0);\n",
         "        if (blockIdx.x == 0 && w.tid == 0) sm90::g_trace_on[g] = (slot == 10 && c0 == 0);\n"
         + _KSTAMP % 60 + "        chunk_dists(P, w, z_ray, S, c0);\n"),
        ("fused_render.cu",
         "        composite_chunk<EMIT_WEIGHTS>(P, w, S, c0, w_ray, T, acc_r, acc_g, acc_b);\n",
         _KSTAMP % 62
         + "        composite_chunk<EMIT_WEIGHTS>(P, w, S, c0, w_ray, T, acc_r, acc_g, acc_b);\n"
         + _KSTAMP % 63),
        ("fused_render.cu", "const char* sfm_cuda_error_string(int code) {",
         "int sfm_trace(long long* out) {\n"
         "  return cudaMemcpyFromSymbol(out, sm90::g_trace, sizeof(sm90::g_trace));\n}\n\n"
         "const char* sfm_cuda_error_string(int code) {"),
    ],
}


def variant_dir(name):
    """A copy of csrc/ with the variant's edits; raises if one does not apply."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d, ignore=shutil.ignore_patterns("_build"))
    for f, old, new in PATCHES[name]:
        path = os.path.join(d, f)
        with open(path) as fh:
            src = fh.read()
        if old not in src:
            raise RuntimeError(f"variant {name}: edit does not apply to {f}: {old[:60]!r}")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    return d


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
    fr.fused_render_rays(packed, o, d, z, rcfg)
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
        n_pass = len(fr.render_plan(packed).passes)
        kinds = [p.kind for p in fr.render_plan(packed).passes]
        for g in range(2):
            t0 = t[0, 60]
            passes = []
            for p in range(n_pass):
                a, b, c = t[g, 3 * p], t[g, 3 * p + 1], t[g, 3 * p + 2]
                nxt = t[g, 3 * p + 3] if p + 1 < n_pass else t[g, 62]
                passes.append({"kind": kinds[p], "start": int(a - t0),
                               "product": int(b - a) if b else None,
                               "epilogue": int(c - b) if b else None,
                               "product_and_epilogue": int(c - a), "barrier": int(nxt - c)})
            out[f"warpgroup_{g}"] = {
                "chunk_start": int(t[g, 60] - t0), "until_first_product": int(t[g, 0] - t[g, 60]),
                "layer_chain": int(t[g, 62] - t[g, 0]), "composite": int(t[g, 63] - t[g, 62]),
                "passes": passes}
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
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
