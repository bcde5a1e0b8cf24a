"""The port's package stands alone: importing it and all its submodules,
or running chip_smoke.py, loads no jax, nothing of sfm_nerf_tpu and nothing
of native/, nor any of the image libraries the card's machine lacks
(matplotlib, cv2, PIL, imageio), and its entry points default to the
card."""

import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, pkgutil, sys
import sfm_nerf_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "sfm_nerf_tpu" or k.startswith("sfm_nerf_tpu."))
print(len(mods), bad)
assert not bad, bad
for sub in ("io", "models", "ops", "kernels", "train", "utils", "cli", "sfm",
            "kernels.fused_train", "kernels._build", "train.nerf_trainer",
            "train.checkpoint", "models.convert", "ops.rays", "config",
            "io.sfm_data", "io.artifacts", "ops.linalg", "ops.lm", "ops.epipolar",
            "ops.triangulation", "ops.pnp", "ops.ba", "sfm.tracks", "sfm.pipeline",
            "sfm.to_nerf", "cli.sfm", "parallel", "parallel.mesh", "parallel.train_step",
            "parallel.render", "parallel.ransac", "parallel.ba", "ops.essential5",
            "ops.rotation_avg", "ops.translation_avg", "utils.profiling", "utils.debug",
            "train.async_ckpt", "cli.wrapper", "io.gif", "cli.gif", "cli.synth_scene"):
    assert "sfm_nerf_tpu_torch." + sub in sys.modules, sub
# nothing of native/: no module from that directory, no library it builds
import os
native = os.path.abspath("native") + os.sep
from_native = sorted(k for k, m in sys.modules.items()
                     if os.path.abspath(getattr(m, "__file__", None) or "").startswith(native))
assert not from_native, from_native
with open("/proc/self/maps") as f:
    assert "libmatching_parser" not in f.read()
"""

# chip_smoke.py imports everything it drives before it looks for a card; with
# no card visible its main() returns 2 having printed no result
_SMOKE_PROBE = r"""
import sys
import chip_smoke
rc = chip_smoke.main()
assert rc == 2, rc
for mod in ("kernels.fused_render", "kernels.fused_train", "train.nerf_trainer",
            "train.checkpoint", "cli.nerf"):
    assert "sfm_nerf_tpu_torch." + mod in sys.modules, mod
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "sfm_nerf_tpu" or k.startswith("sfm_nerf_tpu."))
assert not bad, bad
"""


def _run(probe):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    out = _run(_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods >= 44, out.stdout


def test_chip_smoke_imports_no_jax():
    out = _run(_SMOKE_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    assert '"ok"' not in out.stdout, out.stdout


# the figures are drawn and encoded by the port itself (io/figure.py,
# io/jpeg.py, io/png.py): neither the package nor chip_smoke.py loads an
# image library, even where one is installed
_NO_IMAGE_LIBS = r"""
import importlib, pkgutil, sys
import sfm_nerf_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
assert chip_smoke.main() == 2
assert "sfm_nerf_tpu_torch.io.figure" in sys.modules and "sfm_nerf_tpu_torch.io.jpeg" in sys.modules
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("matplotlib", "mpl_toolkits", "cv2", "PIL", "imageio"))
print(bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_image_library():
    out = _run(_NO_IMAGE_LIBS)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda():
    import sfm_nerf_tpu_torch
    from sfm_nerf_tpu_torch.cli.nerf import config_parser

    assert sfm_nerf_tpu_torch.DEFAULT_DEVICE == "cuda"
    for mode in ("train", "test", "gif"):
        assert config_parser(mode).parse_args([]).device == "cuda"
    from sfm_nerf_tpu_torch.cli import synth_scene, wrapper
    from sfm_nerf_tpu_torch.utils.profiling import StepTimer

    assert wrapper.config_parser().parse_args([]).device == "cuda"
    args = synth_scene.config_parser().parse_args([])
    assert (args.device, args.trace_backend) == ("cuda", "torch")
    assert StepTimer.__init__.__defaults__ == ("cuda",)


# train mode with no card visible (CUDA_VISIBLE_DEVICES="" in _run): the
# child exits through SystemExit before it reads any data
_TRAIN_PROBE = r"""
from sfm_nerf_tpu_torch.cli.nerf import main
try:
    main(["--mode", "train"])
except SystemExit as e:
    assert "no CUDA device" in str(e.code) and "--device cpu" in str(e.code), e.code
    print("exited:", e.code)
else:
    raise AssertionError("--mode train without a card must exit")
"""


def test_sfm_cli_defaults_to_cuda():
    from sfm_nerf_tpu_torch.cli.sfm import config_parser

    assert config_parser().parse_args([]).device == "cuda"


# cli.sfm with no card visible and no --device cpu: it exits before it reads
# any data, and never computes on the CPU unasked
_SFM_PROBE = r"""
from sfm_nerf_tpu_torch.cli.sfm import main
try:
    main(["--data_path", "no/such/dir"])
except SystemExit as e:
    assert "no CUDA device" in str(e.code) and "--device cpu" in str(e.code), e.code
    print("exited:", e.code)
else:
    raise AssertionError("cli.sfm without a card must exit")
"""


def test_sfm_cli_exits_nonzero_without_a_card():
    out = _run(_SFM_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "exited:" in out.stdout, out.stdout
    # and as a process: a non-zero exit status
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.path.abspath(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "sfm_nerf_tpu_torch.cli.sfm",
                           "--data_path", "no/such/dir"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr


def test_train_mode_exits_nonzero():
    """Train mode runs on the card unless --device cpu is given: with no
    card visible it exits non-zero and says so, and trains nothing on the
    CPU unasked.  Run in a child process that sees no card, so the test
    means the same on a machine that has one."""
    out = _run(_TRAIN_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "exited:" in out.stdout, out.stdout
