"""The port's package stands alone: importing it and all its submodules,
or running chip_smoke.py, loads no jax and nothing of sfm_nerf_tpu, and its
entry points default to the card."""

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
for sub in ("io", "models", "ops", "kernels", "train", "utils", "cli",
            "kernels.fused_train", "kernels._build", "train.nerf_trainer",
            "train.checkpoint", "models.convert", "ops.rays"):
    assert "sfm_nerf_tpu_torch." + sub in sys.modules, sub
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
    assert n_mods >= 16, out.stdout


def test_chip_smoke_imports_no_jax():
    out = _run(_SMOKE_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    assert '"ok"' not in out.stdout, out.stdout


def test_entry_points_default_to_cuda():
    import sfm_nerf_tpu_torch
    from sfm_nerf_tpu_torch.cli.nerf import config_parser

    assert sfm_nerf_tpu_torch.DEFAULT_DEVICE == "cuda"
    for mode in ("train", "test", "gif"):
        assert config_parser(mode).parse_args([]).device == "cuda"


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


def test_train_mode_exits_nonzero():
    """Train mode runs on the card unless --device cpu is given: with no
    card visible it exits non-zero and says so, and trains nothing on the
    CPU unasked.  Run in a child process that sees no card, so the test
    means the same on a machine that has one."""
    out = _run(_TRAIN_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "exited:" in out.stdout, out.stdout
