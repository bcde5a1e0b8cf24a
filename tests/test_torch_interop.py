"""The port's last slice against the JAX package on the CPU: reference .pth
files both ways (three layouts, a training save), the .pth fine-tune resume
and gif mode's checkpoint order; the TensorBoard event log against
tensorboardX; the bf16 compute cast on the nn.Module training route against
JAX's make_loss_fn (flat and hierarchical, the convergence case, the dp step
at world 1); the focal formulas; the PnP failure dump.

Sizes: hidden 16-32, 16x16 images, 8-32 samples per ray, 16-64 rays.  All
inputs are numpy arrays made from a seed and fed to both packages; the JAX
loss runs on its XLA route (no Pallas kernel is on it)."""

import dataclasses
import glob
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JaxModelConfig
from sfm_nerf_tpu.config import NeRFPipelineConfig as JaxPipelineConfig
from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
from sfm_nerf_tpu.config import TrainConfig as JaxTrainConfig
from sfm_nerf_tpu.io import blender as jblender
from sfm_nerf_tpu.models import convert as jconvert
from sfm_nerf_tpu.models import init_nerf_params
from sfm_nerf_tpu.train import checkpoint as jckpt
from sfm_nerf_tpu.train import nerf_trainer as jtrainer
from sfm_nerf_tpu_torch.cli import nerf as cli_nerf
from sfm_nerf_tpu_torch.cli import wrapper
from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.io import blender as tblender
from sfm_nerf_tpu_torch.io.png import decode_png, read_png
from sfm_nerf_tpu_torch.models import convert as tconvert
from sfm_nerf_tpu_torch.models.convert import params_from_jax, params_to_jax
from sfm_nerf_tpu_torch.models.nerf import Bf16Linear, NeRF, _linear
from sfm_nerf_tpu_torch.train import checkpoint as tckpt
from sfm_nerf_tpu_torch.train.nerf_trainer import (
    NeRFTrainer, fused_train_supported, make_loss_fn, make_optimizer, make_train_step,
)
from sfm_nerf_tpu_torch.utils import tb_events
from util_synthetic import make_blender_dataset

REPO = os.path.join(os.path.dirname(__file__), "..")
MODEL = dict(hidden=32, n_pos_freq=4, n_dir_freq=2)
LAYOUTS = {   # the three reference layouts, as JAX configs
    "active": dict(arch="active", **MODEL),
    "legacy": dict(arch="legacy", **MODEL),
    # the skip-less no-PE layout: block1 holds 4 layers + the 3-layer tail
    "nope": dict(arch="legacy", hidden=32, pos_encoding=False, has_skip=False,
                 n_block1_layers=4),
}
# bf16 loss and grads, port vs JAX (measured 3.5e-7 and 2.0e-3 at worst; the
# float32 route on the same draws is 3.6e-5 and 3.2e-2 away)
LOSS_RTOL, GRAD_REL = 1e-5, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_params(layout, seed=0):
    jcfg = JaxModelConfig(**LAYOUTS[layout])
    return jcfg, _np(init_nerf_params(jax.random.key(seed), jcfg))


def _same_config(port_cfg, jax_cfg):
    port = dataclasses.asdict(port_cfg)
    theirs = {k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in port}
    assert port == theirs


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def _export(pkg, layout, params, path):
    jcfg = JaxModelConfig(**LAYOUTS[layout])
    if layout == "active":
        pkg.export_active_to_pth(params, path)
    else:
        pkg.export_legacy_to_pth(params, jcfg if pkg is jconvert else _port_mcfg(jcfg), path)


def _port_mcfg(jcfg):
    names = {f.name for f in dataclasses.fields(NeRFModelConfig)}
    return NeRFModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


# ---------------------------------------------------------------------------
# .pth files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_jax_exported_pth_reads_as_jax_reads_it(layout, tmp_path):
    """A file JAX's exporter wrote: the port's convert_pth gives every array
    bit-equal to JAX's convert_pth of the same file, and the same config."""
    _, params = _jax_params(layout)
    path = str(tmp_path / "final_model.pth")
    _export(jconvert, layout, params, path)
    got, cfg = tconvert.convert_pth(path)
    want, jcfg = jconvert.convert_pth(path)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)
    _same_config(cfg, jcfg)
    assert cfg.arch == LAYOUTS[layout]["arch"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_exported_pth_reads_in_jax(layout, tmp_path):
    """The port's exporters write the reference key names: JAX's
    convert_pth reads the file bit-equal to the source tree, and its state
    dict equals the one JAX's exporter writes."""
    _, params = _jax_params(layout, seed=1)
    ours, theirs = str(tmp_path / "ours.pth"), str(tmp_path / "theirs.pth")
    _export(tconvert, layout, params, ours)
    _export(jconvert, layout, params, theirs)
    got, jcfg = jconvert.convert_pth(ours)
    _assert_trees_equal(got, params)
    assert jcfg == JaxModelConfig(**{**dataclasses.asdict(JaxModelConfig()), **LAYOUTS[layout]})
    sd_ours, sd_theirs = (jconvert.load_torch_state_dict(p) for p in (ours, theirs))
    assert list(sd_ours) == list(sd_theirs)
    for k in sd_ours:
        assert sd_ours[k].dtype == np.float32
        np.testing.assert_array_equal(sd_ours[k], sd_theirs[k], err_msg=k)


def test_training_save_with_optimizer_state(tmp_path):
    """A reference training save, ``{'model_state_dict', 'optimizer_state_dict',
    ...}`` with a real Adam state in it, reads through weights_only=True, its
    model unwrapped: bit-equal to JAX's reading."""
    _, params = _jax_params("legacy", seed=2)
    bare = str(tmp_path / "bare.pth")
    jconvert.export_legacy_to_pth(params, JaxModelConfig(**LAYOUTS["legacy"]), bare)
    sd = torch.load(bare, weights_only=True)
    weights = [torch.nn.Parameter(t.clone()) for t in sd.values()]
    opt = torch.optim.Adam(weights, lr=5e-4)
    sum((w ** 2).sum() for w in weights).backward()
    opt.step()
    path = str(tmp_path / "model_1000.pth")
    torch.save({"iteration": 1000, "model_state_dict": sd,
                "optimizer_state_dict": opt.state_dict(), "loss": 0.25}, path)
    got, cfg = tconvert.convert_pth(path)
    want, jcfg = jconvert.convert_pth(path)
    _assert_trees_equal(got, want)
    _same_config(cfg, jcfg)


def _fine_tune_case(tmp_path):
    """tests/test_train.py:185-235's case: a 2-frame 16^2 dataset, a seeded
    legacy network (hidden 32, L = 4/2) exported to final_model.pth."""
    root = make_blender_dataset(str(tmp_path / "data"), n_frames=2, height=16, width=16)
    images, poses, cam = jblender.load_blender_dataset(root, "train")
    jcfg = JaxModelConfig(**LAYOUTS["legacy"])
    ck = str(tmp_path / "ckpt")
    os.makedirs(ck)
    src = _np(init_nerf_params(jax.random.key(7), jcfg))
    jconvert.export_legacy_to_pth(src, jcfg, os.path.join(ck, "final_model.pth"))

    def configs(**model):
        mj = JaxModelConfig(**{**LAYOUTS["legacy"], **model})
        common = dict(checkpoint_path=ck, load_checkpoint=True)
        j = JaxPipelineConfig(model=mj, render=JaxRenderConfig(n_sample=32, near=2.0, far=6.0),
                              train=JaxTrainConfig(n_rays_batch=128, val_every=0), **common)
        t = NeRFPipelineConfig(model=_port_mcfg(mj), render=RenderConfig(n_sample=32),
                               train=TrainConfig(n_rays_batch=128, val_every=0), **common)
        return j, t

    return (np.asarray(images), np.asarray(poses), cam.camera_matrix), ck, src, configs


def test_try_resume_pth_matches_jax(tmp_path, capsys):
    """No npz in checkpoint_path, a .pth there: both trainers start at step 0
    from its weights (bit-equal) under a fresh optimizer and train on; an
    active config raises 'different architecture' in both; a coarse/fine
    pair prints the same note in both and trains from scratch."""
    data, ck, src, configs = _fine_tune_case(tmp_path)
    jcfg, tcfg = configs()
    jt = jtrainer.NeRFTrainer(jcfg, *data)
    tt = NeRFTrainer(tcfg, *data, device="cpu")
    assert jt.try_resume() and tt.try_resume()
    assert jt.start_iter == tt.start_iter == 0
    assert "Fine-tuning from converted" in capsys.readouterr().out
    _assert_trees_equal(params_to_jax(tt.model), _np(jt.params))
    _assert_trees_equal(params_to_jax(tt.model), src)
    assert not tt.optimizer.state and tt.scheduler.last_epoch == 0
    tt.fit(max_iters=3, progress=False)
    assert tt.start_iter == 0 and len(tt.loss_log) == 1
    for f in glob.glob(os.path.join(ck, "*.npz")):
        os.remove(f)
    jbad, tbad = configs(arch="active")
    for trainer in (jtrainer.NeRFTrainer(jbad, *data), NeRFTrainer(tbad, *data, device="cpu")):
        with pytest.raises(ValueError, match="different architecture"):
            trainer.try_resume()
    jhier, thier = (dataclasses.replace(c, render=dataclasses.replace(c.render, n_importance=8))
                    for c in configs())
    capsys.readouterr()
    notes = []
    for trainer in (jtrainer.NeRFTrainer(jhier, *data), NeRFTrainer(thier, *data, device="cpu")):
        capsys.readouterr()
        assert not trainer.try_resume()
        notes.append(capsys.readouterr().out)
    assert notes[0] == notes[1] and notes[1].startswith("note: ignoring")


def test_try_resume_pth_takes_the_numerically_newest(tmp_path):
    """Without final_model.pth both trainers take model_10000.pth over
    model_9000.pth, and an npz beside them wins over both."""
    data, ck, _, configs = _fine_tune_case(tmp_path)
    os.remove(os.path.join(ck, "final_model.pth"))
    jcfg, tcfg = configs()
    mcfg = JaxModelConfig(**LAYOUTS["legacy"])
    newer = _np(init_nerf_params(jax.random.key(10), mcfg))
    jconvert.export_legacy_to_pth(_np(init_nerf_params(jax.random.key(9), mcfg)), mcfg,
                                  os.path.join(ck, "model_9000.pth"))
    jconvert.export_legacy_to_pth(newer, mcfg, os.path.join(ck, "model_10000.pth"))
    tt = NeRFTrainer(tcfg, *data, device="cpu")
    assert tt.try_resume() and tt.start_iter == 0
    _assert_trees_equal(params_to_jax(tt.model), newer)
    jt = jtrainer.NeRFTrainer(jcfg, *data)
    assert jt.try_resume()
    _assert_trees_equal(_np(jt.params), newer)
    tckpt.save_checkpoint(ck, 4, params_to_jax(tt.model))
    again = NeRFTrainer(tcfg, *data, device="cpu")
    assert again.try_resume() and again.start_iter == 5


def _jax_wrapper():
    spec = importlib.util.spec_from_file_location(
        "_jax_wrapper_gif", os.path.join(REPO, "Phase2", "Wrapper.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("files,want", [
    (["final_model.ckpt.npz", "model_000005.ckpt.npz", "final_model.pth"],
     "final_model.ckpt.npz"),
    (["model_000005.ckpt.npz", "model_000010.ckpt.npz", "final_model.pth"],
     "model_000010.ckpt.npz"),
    (["final_model.pth", "model_10000.pth"], "final_model.pth"),
    (["model_9000.pth", "model_10000.pth", "model_800.pth"], "model_10000.pth"),
    (["notes.txt"], None),
])
def test_load_any_checkpoint_order_matches_the_wrapper(files, want, tmp_path):
    """gif mode's checkpoint choice against Phase2/Wrapper.py's
    load_any_checkpoint on the same directory: the npz first, then
    final_model.pth, then the numerically newest model_*.pth."""
    for f in files:
        (tmp_path / f).write_bytes(b"")
    got = cli_nerf.load_any_checkpoint(str(tmp_path))
    theirs = _jax_wrapper().load_any_checkpoint(str(tmp_path))
    assert got == theirs
    if want is None:
        assert got == (None, None)
    else:
        assert os.path.basename(got[0]) == want
        assert got[1] == ("pth" if want.endswith(".pth") else None)
    assert cli_nerf.load_any_checkpoint(str(tmp_path / "missing")) == (None, None)


@pytest.mark.parametrize("layout", ["active", "nope"])
def test_wrapper_gif_renders_a_pth_as_its_npz(layout, tmp_path):
    """``cli.wrapper --mode gif --device cpu`` on a directory that holds only
    a .pth renders the frames it renders from the npz of the same weights,
    bit for bit (the fused route's plain version on the CPU)."""
    data = make_blender_dataset(str(tmp_path / "scene"), n_frames=2, height=16, width=16)
    _, params = _jax_params(layout, seed=4)     # seed 3's no-PE net has no density
    pth_dir, npz_dir = tmp_path / "pth", tmp_path / "npz"
    os.makedirs(pth_dir / "scene")
    _export(tconvert, layout, params, str(pth_dir / "scene" / "final_model.pth"))
    tckpt.save_checkpoint(str(npz_dir / "scene"), 0, params, final=True)
    frames = {}
    for name, ck in (("pth", pth_dir), ("npz", npz_dir)):
        records = wrapper.main(["--mode", "gif", "--device", "cpu", "--data_path", data + "/",
                                "--checkpoint_path", str(ck), "--images_path",
                                str(tmp_path / ("img_" + name)), "--n_frames", "2",
                                "--n_sample", "32", "--no_perturb"])
        frames[name] = [read_png(r["path"]) for r in records]
    assert len(frames["pth"]) == 2
    for a, b in zip(frames["pth"], frames["npz"]):
        np.testing.assert_array_equal(a, b)
    assert max(f.std() for f in frames["pth"]) > 0


# ---------------------------------------------------------------------------
# the TensorBoard event log
# ---------------------------------------------------------------------------


SCALARS = [("Loss/train", 0.5, 0), ("Learning Rate", 5e-4, 0), ("Loss/train_avg", 0.25, 4),
           ("Loss/val_0", 1.0e-3, 8), ("/lead slash", -2.0, 123456), ("Loss/train", 3.0e38, 9)]


def _write_both(tmp_path, calls):
    tbx = pytest.importorskip("tensorboardX")
    writers = {"port": tb_events.SummaryWriter(str(tmp_path / "port")),
               "tbx": tbx.SummaryWriter(str(tmp_path / "tbx"))}
    for w in writers.values():
        for method, args in calls:
            getattr(w, method)(*args)
        w.close()
    return {k: glob.glob(str(tmp_path / k / "events.out.tfevents.*")) for k in writers}


def test_scalar_records_equal_tensorboardx(tmp_path):
    """For the same add_scalar calls the port's records, less the wall time
    (the first field, 9 bytes), are tensorboardX's byte for byte; the first
    record is the file_version event."""
    files = _write_both(tmp_path, [("add_scalar", s) for s in SCALARS])
    assert len(files["port"]) == len(files["tbx"]) == 1
    ours = list(tb_events._read_records(files["port"][0]))
    theirs = list(tb_events._read_records(files["tbx"][0]))
    assert len(ours) == len(theirs) == len(SCALARS) + 1
    assert [r[9:] for r in ours] == [r[9:] for r in theirs]
    events = tb_events._read_events(files["port"][0])
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(e["values"][0]["tag"], e["values"][0]["simple_value"], e["step"])
           for e in events[1:]]
    assert got == [(tb_events.clean_tag(t), float(np.float32(v)), s) for t, v, s in SCALARS]
    assert got[1][0] == "Learning_Rate" and got[4][0] == "lead_slash"


@pytest.mark.parametrize("kind", ["float_rgb", "uint8_rgb", "float_grey"])
def test_image_records_decode_to_tensorboardx_pixels(kind, tmp_path):
    """add_image of a CHW image: the same tag, step, height, width and
    colorspace as tensorboardX's record, and PNGs that decode to the same
    pixels (the two PNG encoders compress differently)."""
    rng = np.random.default_rng(4)
    img = {"float_rgb": rng.uniform(0, 1, (3, 12, 20)).astype(np.float32),
           "uint8_rgb": rng.integers(0, 256, (3, 12, 20)).astype(np.uint8),
           "float_grey": rng.uniform(0, 1, (1, 12, 20)).astype(np.float32)}[kind]
    files = _write_both(tmp_path, [("add_image", ("Val_Image_0", img, 8))])
    ours, theirs = (tb_events._read_events(files[k][0])[1] for k in ("port", "tbx"))
    assert ours["step"] == theirs["step"] == 8
    (vo,), (vt,) = ours["values"], theirs["values"]
    assert vo["tag"] == vt["tag"] == "Val_Image_0"
    meta = lambda v: {k: v["image"][k] for k in ("height", "width", "colorspace")}
    assert meta(vo) == meta(vt) == {"height": 12, "width": 20, "colorspace": 3}
    np.testing.assert_array_equal(decode_png(vo["image"]["png"]), decode_png(vt["image"]["png"]))
    np.testing.assert_array_equal(decode_png(vo["image"]["png"]), tb_events.image_hwc_u8(img))


def test_crc32c_and_tensorboard_reader(tmp_path):
    """The table-driven CRC32C against the standard check value and
    tensorboardX's; tensorboard's own loader reads the port's file."""
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    tbx_crc = pytest.importorskip("tensorboardX.crc32c")
    data = np.random.default_rng(5).integers(0, 256, 4099).astype(np.uint8).tobytes()
    assert tb_events.crc32c(data) == tbx_crc.crc32c(data)
    w = tb_events.SummaryWriter(str(tmp_path))
    for tag, v, s in SCALARS[:3]:
        w.add_scalar(tag, v, s)
    w.add_image("Val_Image_0", np.zeros((3, 4, 6), np.float32), 2)
    w.close()
    loader = pytest.importorskip("tensorboard.backend.event_processing.event_file_loader")
    events = list(loader.EventFileLoader(w.path).Load())
    assert len(events) == 5 and events[0].file_version == "brain.Event:2"
    assert [e.step for e in events[1:]] == [0, 0, 4, 2]
    assert events[1].summary.value[0].tag == "Loss/train"


def test_cli_train_writes_the_trainers_tags(tmp_path):
    """``cli.nerf --mode train --device cpu`` writes one event file under
    {--logs_path}/{--exp_name} holding the JAX trainer's tags
    (sfm_nerf_tpu/train/nerf_trainer.py:819-862): Loss/train, Learning Rate
    and Loss/train_avg every --log_every steps, Loss/val_i and Val_Image_i
    (ground truth beside prediction) every --val_every; the scalars equal
    the losses the trainer logged."""
    data = make_blender_dataset(str(tmp_path / "data" / "scene"), n_frames=3,
                                height=16, width=16)
    stats = cli_nerf.main([
        "--mode", "train", "--device", "cpu", "--data_path", data + "/",
        "--checkpoint_path", str(tmp_path / "ck"), "--logs_path", str(tmp_path / "logs"),
        "--exp_name", "tiny", "--n_sample", "16", "--n_rays_batch", "64",
        "--hidden_size", "32", "--n_pos_freq", "4", "--n_dirc_freq", "2",
        "--max_iters", "9", "--log_every", "4", "--val_every", "8", "--save_ckpt_iter", "0"])
    files = glob.glob(str(tmp_path / "logs" / "tiny" / "events.out.tfevents.*"))
    assert files == [stats["events"]]
    events = tb_events._read_events(files[0])[1:]
    by_tag = {}
    for e in events:
        for v in e["values"]:
            by_tag.setdefault(v["tag"], []).append((e["step"], v.get("simple_value", v.get("image"))))
    n_val = len(stats["val"])
    assert set(by_tag) == {"Loss/train", "Learning_Rate", "Loss/train_avg",
                           *[f"Loss/val_{i}" for i in range(n_val)],
                           *[f"Val_Image_{i}" for i in range(n_val)]}
    assert by_tag["Loss/train"] == [(it, float(np.float32(v))) for it, v in stats["losses"]]
    assert [s for s, _ in by_tag["Learning_Rate"]] == [0, 4, 8]
    assert [v for _, v in by_tag["Loss/val_0"]] == [float(np.float32(stats["val"][0][2]))]
    img = by_tag["Val_Image_0"][0][1]
    assert (by_tag["Val_Image_0"][0][0], img["height"], img["width"], img["colorspace"]) == \
        (8, 16, 32, 3)
    assert decode_png(img["png"]).shape == (16, 32, 3)


# ---------------------------------------------------------------------------
# bf16 compute on the nn.Module route
# ---------------------------------------------------------------------------


def _bf16_case(hier, n_rays=32, n_sample=16, n_imp=8, seed=0):
    """JAX's make_loss_fn on its XLA route with compute_dtype bf16 (loss and
    grads), and the port's inputs that reproduce its draws: the pixels from
    the sampling key's three sub-keys, the depth jitter and the importance
    jitter from the render key (split in two when hierarchical)."""
    rng = np.random.default_rng(seed)
    n_img, hw = 3, 16
    images = rng.uniform(0, 1, (n_img, hw, hw, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1))
    poses[:, 2, 3] = 4.0
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(n_img, 3, 3)))[0]
    focal = 0.5 * 0.6911 * hw / np.tan(0.5 * 0.6911)
    K = np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1]], np.float32)
    mcfg = JaxModelConfig(**MODEL)
    params = _np(init_nerf_params(jax.random.key(seed), mcfg))
    if hier:
        params = {"coarse": params, "fine": _np(init_nerf_params(jax.random.key(9), mcfg))}
    jcfg = JaxPipelineConfig(
        model=mcfg, render=JaxRenderConfig(n_sample=n_sample, n_importance=n_imp if hier else 0),
        train=JaxTrainConfig(n_rays_batch=n_rays, compute_dtype="bfloat16"))
    assert not jtrainer.fused_train_supported(jcfg)
    ks, kr = jax.random.split(jax.random.key(seed + 100))
    jl, jg = jax.value_and_grad(jtrainer.make_loss_fn(jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params), ks, kr, *map(jnp.asarray, (images, poses, K)))
    draws = tuple(torch.from_numpy(np.asarray(jax.random.randint(k, (n_rays,), 0, hi)))
                  for k, hi in zip(jax.random.split(ks, 3), (n_img, hw, hw)))
    kz, kpdf = jax.random.split(kr) if hier else (kr, None)
    u = torch.from_numpy(np.asarray(jax.random.uniform(kz, (n_rays, n_sample))))
    u_pdf = (torch.from_numpy(np.asarray(jax.random.uniform(kpdf, (n_rays, n_imp))))
             if hier else None)
    cfg = NeRFPipelineConfig(
        model=_port_mcfg(mcfg), render=RenderConfig(n_sample=n_sample,
                                                    n_importance=n_imp if hier else 0),
        train=TrainConfig(n_rays_batch=n_rays, compute_dtype="bfloat16"))
    batch = tuple(torch.from_numpy(a) for a in (images, poses, K))
    return dict(params=params, cfg=cfg, batch=batch, draws=draws, u=u, u_pdf=u_pdf,
                loss=float(jl), grads=_np(jg))


def _port_loss(case, cfg=None):
    """The port's loss and its grads in the JAX layout, from ``case``'s
    params and draws."""
    cfg = cfg or case["cfg"]
    model = params_from_jax(case["params"], cfg.model)
    loss = make_loss_fn(cfg)(model, None, *case["batch"], draws=case["draws"], u=case["u"],
                             u_pdf=case["u_pdf"])
    loss.backward()
    grads = tconvert._layers(model, lambda t, key: (t.grad.T if key == "w" else t.grad).numpy())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return float(loss.detach()), grads


def _worst_grad(grads, want):
    """The largest ||g - g_jax|| / ||g_jax|| over the grad tensors."""
    return max(np.linalg.norm(g - gj) / max(np.linalg.norm(gj), 1e-30)
               for g, gj in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(want)))


def assert_bf16_matches_jax(case):
    """The port's bf16 nn.Module loss against JAX's: the loss to LOSS_RTOL,
    every grad tensor to GRAD_REL of its norm."""
    loss, grads = _port_loss(case)
    assert not fused_train_supported(case["cfg"])
    np.testing.assert_allclose(loss, case["loss"], rtol=LOSS_RTOL)
    assert _worst_grad(grads, case["grads"]) <= GRAD_REL


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hierarchical"])
def test_bf16_module_route_matches_jax(hier):
    """compute_dtype='bfloat16' on the nn.Module route against JAX's
    make_loss_fn on its XLA route: the loss to 1e-5 relative, every grad to
    5e-3 of its norm; the float32 route on the same draws misses that rule,
    so the rule sees the cast."""
    case = _bf16_case(hier)
    assert_bf16_matches_jax(case)
    loss32, grads32 = _port_loss(case, dataclasses.replace(
        case["cfg"], train=TrainConfig(n_rays_batch=32)))
    assert _worst_grad(grads32, case["grads"]) > 2 * GRAD_REL


def test_card_linear_agrees_with_the_reference_on_the_cpu():
    """Bf16Linear (the card's tensor-core product, run here through its
    CPU product) against _linear's autograd reference: the same forward,
    and grads within the extra rounding of the output cotangent to bf16."""
    rng = np.random.default_rng(6)
    layer = torch.nn.Linear(48, 24)
    with torch.no_grad():
        layer.weight.data = layer.weight.data.to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(5, 7, 48)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(5, 7, 24)).astype(np.float32))
    y_ref = _linear(layer, x)
    y_ref.backward(g)
    ref = [t.grad.clone() for t in (x, layer.weight, layer.bias)]
    for t in (x, layer.weight, layer.bias):
        t.grad = None
    y = Bf16Linear.apply(x, layer.weight, layer.bias)
    y.backward(g)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for got, want in zip((x.grad, layer.weight.grad, layer.bias.grad), ref):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert (got.float() - want.float()).norm() <= 1e-2 * want.float().norm()


def test_bf16_training_converges(tmp_path):
    """tests/test_train.py:118 on the port: bf16 compute with float32
    masters tracks float32 training (hidden 16, L = 2/1, 8 samples, 151
    steps at 5e-3)."""
    root = make_blender_dataset(str(tmp_path / "bf"), n_frames=2, height=16, width=16)
    images, poses, cam = tblender.load_blender_dataset(root, "train")
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = NeRFPipelineConfig(
            model=NeRFModelConfig(hidden=16, n_pos_freq=2, n_dir_freq=1),
            render=RenderConfig(n_sample=8),
            train=TrainConfig(n_rays_batch=64, lrate=5e-3, val_every=0, compute_dtype=dtype),
            checkpoint_path=os.path.join(str(tmp_path), "ck_" + dtype), load_checkpoint=False)
        tr = NeRFTrainer(cfg, images, poses, cam.camera_matrix, device="cpu")
        tr.fit(max_iters=151, progress=False)
        losses[dtype] = [v for _, v in tr.loss_log]
    assert losses["bfloat16"][-1] < losses["bfloat16"][0] * 0.8
    assert losses["bfloat16"][-1] < max(losses["float32"][-1] * 5, 0.01)


def test_dp_step_at_world_one_equals_the_one_device_step_under_bf16():
    """The data-parallel step (gloo, one rank) reaches make_loss_fn's bf16
    cast as the one-device step does: the same loss and, after two steps,
    the same parameters bit for bit (the JAX dp step once lost the cast,
    sfm_nerf_tpu/train/nerf_trainer.py:110-114)."""
    import socket

    import torch.distributed as dist

    from sfm_nerf_tpu_torch.parallel import mesh as pmesh
    from sfm_nerf_tpu_torch.parallel.train_step import make_dp_train_step

    case = _bf16_case(False)
    cfg = case["cfg"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        mesh = pmesh.make_mesh(1, 1, "cpu")
        out = []
        for dp in (False, True):
            model = params_from_jax(case["params"], cfg.model)
            opt, sched = make_optimizer(cfg, model)
            step = (make_dp_train_step(cfg, opt, sched, mesh) if dp
                    else make_train_step(cfg, opt, sched))
            gen = torch.Generator().manual_seed(5)
            losses = [float(step(model, gen, *case["batch"])) for _ in range(2)]
            out.append((losses, params_to_jax(model)))
    finally:
        dist.destroy_process_group()
    assert out[0][0] == out[1][0]
    _assert_trees_equal(out[1][1], out[0][1])
    assert out[0][1]["fc1"]["w"].dtype == np.float32


# ---------------------------------------------------------------------------
# the focal formulas; the PnP failure dump
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("formula", ["reference", "standard"])
def test_focal_formula_matches_jax(formula, tmp_path):
    root = make_blender_dataset(str(tmp_path / "f"), n_frames=2, height=16, width=24)
    _, _, cam_t = tblender.load_blender_dataset(root, "train", focal_formula=formula)
    _, _, cam_j = jblender.load_blender_dataset(root, "train", focal_formula=formula)
    np.testing.assert_array_equal(cam_t.camera_matrix, cam_j.camera_matrix)
    assert tblender.derive_focal(0.7, 24, formula) == jblender.derive_focal(0.7, 24, formula)
    if formula == "standard":
        _, _, ref = tblender.load_blender_dataset(root, "train")
        assert cam_t.camera_matrix[0, 0] != ref.camera_matrix[0, 0]
    for loader in (tblender.derive_focal, jblender.derive_focal):
        with pytest.raises(ValueError, match="unknown focal formula"):
            loader(0.7, 24, "fisheye")


def test_pnp_failure_dump(tmp_path, monkeypatch):
    """A camera whose PnP finds fewer than 6 inliers (pure-noise 2D points)
    is dumped under SFM_NERF_DUMP_PNP_FAILURES as fail_cam{i}_try{n}.npz
    with obj, img, K and n_inliers, as the JAX pipeline dumps it; without
    the variable nothing is written."""
    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

    rng = np.random.default_rng(7)
    obj = rng.uniform(-1, 1, (40, 3)) + np.array([0.0, 0.0, 6.0])
    img = rng.uniform(0, 800, (40, 2))
    K = np.array([[700.0, 0, 400], [0, 700.0, 300], [0, 0, 1]])
    pipe = SfMPipeline(SfMConfig(pnp_iters=256, pnp_refine_iters=5), device="cpu")
    assert pipe.register_camera(3, obj, img, K) == (None, None)
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("SFM_NERF_DUMP_PNP_FAILURES", str(tmp_path / "dump"))
    assert pipe.register_camera(3, obj, img, K) == (None, None)
    (path,) = glob.glob(str(tmp_path / "dump" / "*.npz"))
    assert os.path.basename(path) == "fail_cam3_try2.npz"
    with np.load(path) as z:
        assert sorted(z.files) == ["K", "img", "n_inliers", "obj"]
        np.testing.assert_array_equal(z["obj"], obj)
        np.testing.assert_array_equal(z["img"], img)
        np.testing.assert_array_equal(z["K"], K)
        assert int(z["n_inliers"]) < 6
