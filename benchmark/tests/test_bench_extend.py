"""A later change adds a cell, a configuration with a network of its own,
a traffic mix and a per-layer metric as new files and entries only: in a
copy of the benchmark, the harness finds and runs them, and no file that
was there changes."""

import hashlib
import json
import os
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

# The legacy arch of the reference's Phase2/Wrapper.py, as a later change
# would add it: its plain network and counts in a file of its own.
LEGACY = '''"""The legacy NeRF MLP: fc1, block1, a skip layer, block2 ending in a
(hidden + 1)-wide ReLU layer whose channel 0 is the density; the rgb head."""

import torch

from benchmark.reference.nerf import dir_dim, embed, pos_dim

DENSITY_BIAS = ("block2_2", 0)


def layer_shapes(m):
    h, p = m["hidden"], pos_dim(m)
    shapes = {"fc1": (p, h)}
    shapes.update({f"block1_{i}": (h, h) for i in range(m["n_block1_layers"])})
    shapes["skip"] = (h + p, h)
    shapes.update({"block2_0": (h, h), "block2_1": (h, h), "block2_2": (h, h + 1),
                   "density_fc": (h, 1), "rgb1": (h + dir_dim(m), 128), "rgb2": (128, 3)})
    return shapes


def mlp(m, pts, dirs, lin):
    pe, de = embed(m, pts, dirs)
    h = torch.relu(lin("fc1", pe))
    for i in range(m["n_block1_layers"]):
        h = torch.relu(lin(f"block1_{i}", h))
    h = torch.relu(lin("skip", torch.cat([h, pe], -1)))
    h = torch.relu(lin("block2_1", torch.relu(lin("block2_0", h))))
    out = torch.relu(lin("block2_2", h))
    rgb_h = torch.relu(lin("rgb1", torch.cat([out[:, 1:], de], -1)))
    return out[:, 0], torch.sigmoid(lin("rgb2", rgb_h))


def macs_per_point(m):
    return sum((m["hidden"] if k == "rgb1" else fi) * fo
               for k, (fi, fo) in layer_shapes(m).items() if k != "density_fc")


def macs_per_ray(m):
    return dir_dim(m) * 128
'''

# (configuration name, its network file or None for the active one, the
# changes to nerf-active-flat's groups)
NEW_CONFIGS = {
    "legacy-white": ("legacy.py", {"model": {"arch": "legacy", "n_block1_layers": 3,
                                             "has_skip": True, "density_bias_init": 0.5},
                                   "render": {"white_background": True}}),
    "active-nope-lindisp": (None, {"model": {"pos_encoding": False},
                                   "render": {"lindisp": True, "near": 1.5}}),
}


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("name", list(NEW_CONFIGS))
def test_new_cell_config_mix_and_metric_are_files(tmp_path, name):
    network, changes = NEW_CONFIGS[name]
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "data"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "nerf-active-flat.json")) as f:
        config = json.load(f)
    config["name"] = name
    for group, over in changes.items():
        config[group] = {**config[group], **over}
    if network:
        with open(os.path.join(b, "reference", network), "w") as f:
            f.write(LEGACY)
        config["reference"] = f"benchmark/reference/{network}"
    with open(os.path.join(b, "configs", name + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(b, "traffic", "train-loop-sparse-log.json"), "w") as f:
        json.dump({"loop": "train", "train": {"log_every": 7}, "warmup_steps": 1,
                   "trace_units": 4}, f)
    with open(os.path.join(b, "limits", "new-train.json"), "w") as f:
        json.dump({"control": "fp8", "limits": {"loss_gap": 1e-3, "grad_gap": 1e-2,
                                                "update_gap": 1e-2}}, f)
    # a metric with no ``workloads`` list: every cell that reports the
    # end-to-end metric it moves reads it
    with open(os.path.join(b, "metrics", "steps_traced.py"), "w") as f:
        f.write('"""steps_traced: units in the traced slice."""\n\nSPANS = []\n\n\n'
                'def read(view):\n    return float(view.units)\n')
    man = harness.manifest(root)
    man["configs"].append({"name": name, "source": "https://example.org/new",
                           "file": f"benchmark/configs/{name}.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "new-train", "config": name,
                             "traffic": "train-loop-sparse-log", "chips": 1, "why": "a test"})
    man["end_to_end"][0]["workloads"].append("new-train")
    man["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "device",
                             "moves": "train_rays_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    spec = harness.resolve("new-train", root)
    assert spec["groups"]["train"]["log_every"] == 7
    # the run's network, and the check's, is the configuration's own file
    assert spec["arch"].__file__ == os.path.join(root, config["reference"])
    assert "steps_traced" in [m["name"] for m in harness.resolve("flat-train", root)["per_layer"]]
    assert "steps_traced" not in [m["name"] for m in
                                  harness.resolve("flat-render", root)["per_layer"]]
    over = tiny.overrides("flat-train")
    over["train"].pop("log_every")
    over.pop("traffic")
    res, _ = harness.run("new-train", 5, 0.2, True, 0.0, root=root, device="cpu",
                         overrides=over)
    assert res["correct"] and res["metrics"]["steps_traced"]["value"] == 4.0, res["checks"]
    res, _ = harness.run("new-train", 5, 0.2, False, 0.0, root=root, device="cpu",
                         overrides=over)
    assert res["correct"] and set(res["metrics"]) == {"train_rays_per_s", "setup_s"}
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
