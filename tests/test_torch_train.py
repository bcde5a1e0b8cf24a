"""The port's training slice against the JAX package on the CPU: ray
sampling, the schedule and Adam against optax, checkpoints carried both
ways, the trainer's loop (loss falls, cadences, interrupt), and three steps
of the port's eager step against the JAX XLA loss under optax.adam.

Sizes: hidden 32, 16x16 images, 16 samples per ray
(tests/util_synthetic.py:tiny_pipeline_setup).  Inputs are numpy arrays made
from a seed and fed to both packages."""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sfm_nerf_tpu.models import nerf_apply
from sfm_nerf_tpu.ops import rays as jrays
from sfm_nerf_tpu.ops.render import composite as jcomposite
from sfm_nerf_tpu.train import checkpoint as jckpt
from sfm_nerf_tpu.train import nerf_trainer as jtrainer
from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.models.convert import (
    optimizer_state_from_jax, optimizer_state_to_jax, params_from_jax, params_to_jax,
)
from sfm_nerf_tpu_torch.models.nerf import NeRF
from sfm_nerf_tpu_torch.ops.rays import sample_ray_batch
from sfm_nerf_tpu_torch.ops.render import stratified_samples
from sfm_nerf_tpu_torch.train import checkpoint as tckpt
from sfm_nerf_tpu_torch.train.nerf_trainer import (
    NeRFTrainer, fused_train_supported, make_loss_fn, make_optimizer, make_schedule,
    make_train_step,
)
from util_synthetic import tiny_pipeline_setup

N_RAYS = 64


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _port_cfg(jcfg, **kw):
    """The port's config with the JAX config's values, field by field."""
    def take(cls, src, **over):
        names = {f.name for f in dataclasses.fields(cls)}
        vals = {k: v for k, v in dataclasses.asdict(src).items() if k in names}
        return cls(**{**vals, **over})

    return NeRFPipelineConfig(
        model=take(NeRFModelConfig, jcfg.model),
        render=take(RenderConfig, jcfg.render, **kw.pop("render", {})),
        train=take(TrainConfig, jcfg.train, **kw.pop("train", {})), **kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tx, params, opt_state, images, poses, K = tiny_pipeline_setup(n_rays=N_RAYS)
    return dict(jcfg=jcfg, tx=tx, params=_np_tree(params), opt_state=opt_state,
                images=np.array(images), poses=np.array(poses), K=np.array(K))


# ---------------------------------------------------------------------------
# ray sampling, init
# ---------------------------------------------------------------------------


def test_sample_ray_batch_matches_jax_on_the_same_draws(tiny):
    """The JAX sampler draws (image, px, py) from three sub-keys; the same
    integers given to the port give the same rays and targets (float32
    products in another order: 1e-6)."""
    key = jax.random.key(5)
    n_img, height, width = tiny["images"].shape[:3]
    ki, kx, ky = jax.random.split(key, 3)
    draws = [np.array(jax.random.randint(k, (N_RAYS,), 0, hi))
             for k, hi in ((ki, n_img), (kx, width), (ky, height))]
    # poses that rotate, so the direction product is exercised
    rng = np.random.default_rng(0)
    poses = tiny["poses"].copy()
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(n_img, 3, 3)))[0]
    oj, dj, tj = jrays.sample_ray_batch(key, jnp.asarray(tiny["images"]), jnp.asarray(poses),
                                        jnp.asarray(tiny["K"]), N_RAYS)
    ot, dt, tt = sample_ray_batch(torch.from_numpy(tiny["images"]), torch.from_numpy(poses),
                                  torch.from_numpy(tiny["K"]), N_RAYS,
                                  draws=tuple(torch.from_numpy(a) for a in draws))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)


def test_sample_ray_batch_draws_from_its_generator(tiny):
    args = [torch.from_numpy(tiny[k]) for k in ("images", "poses", "K")]
    a = sample_ray_batch(*args, 128, torch.Generator().manual_seed(3))
    b = sample_ray_batch(*args, 128, torch.Generator().manual_seed(3))
    c = sample_ray_batch(*args, 128, torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    assert a[0].shape == a[1].shape == a[2].shape == (128, 3)
    np.testing.assert_allclose(a[1].norm(dim=-1).numpy(), 1.0, atol=1e-6)
    # every target is a pixel of the images
    pixels = {tuple(p) for p in tiny["images"].reshape(-1, 3).round(6).tolist()}
    assert all(tuple(t) in pixels for t in a[2].numpy().round(6).tolist())


def test_seeded_init_is_reproducible_and_bounded():
    """Weights and biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as
    sfm_nerf_tpu/models/nerf.py draws them; the seed alone decides them."""
    mcfg = NeRFModelConfig(hidden=32, n_pos_freq=4, n_dir_freq=2)
    torch.manual_seed(0)
    a = NeRF(mcfg, seed=7)
    torch.manual_seed(123)       # the global generator plays no part
    b, c = NeRF(mcfg, seed=7), NeRF(mcfg, seed=8)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        assert not torch.equal(pa, pc), name
    for name, layer in a.layers.items():
        bound = 1.0 / np.sqrt(layer.in_features)
        for p in (layer.weight, layer.bias):
            assert p.abs().max().item() <= bound, name
        w = layer.weight.detach().numpy()
        if w.size >= 1024:       # the uniform's spread: std = bound / sqrt(3)
            np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.1)
            assert abs(w.mean()) < 0.1 * bound


# ---------------------------------------------------------------------------
# schedule and Adam against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 49_999, 50_000, 100_000])
def test_schedule_matches_optax_staircase(tiny, step):
    """lrate * decay ** (step // decay_steps), float32 rounding apart."""
    jcfg = tiny["jcfg"]
    want = float(jtrainer.make_schedule(jcfg)(step))
    got = make_schedule(_port_cfg(jcfg))(step)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_steplr_follows_the_schedule(tiny):
    """torch's StepLR, stepped after every update, hands Adam the schedule's
    rate at every step (checked across three decay boundaries)."""
    cfg = _port_cfg(tiny["jcfg"], train=dict(lrate_decay_steps=7, lrate_decay=0.5))
    model = NeRF(cfg.model, seed=0)
    opt, sched = make_optimizer(cfg, model)
    schedule = make_schedule(cfg)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    for step in range(24):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], schedule(step), rtol=1e-12)
        opt.step()
        sched.step()


@pytest.mark.parametrize("n_steps", [1, 10])
def test_adam_steps_match_optax(tiny, n_steps):
    """Identical params and grads through torch.optim.Adam under StepLR and
    through optax.adam under the staircase schedule (a decay boundary inside
    the ten steps): the params agree to 1e-6 absolute (updates are ~5e-4)."""
    jcfg = dataclasses.replace(
        tiny["jcfg"], train=dataclasses.replace(tiny["jcfg"].train, lrate_decay_steps=4))
    cfg = _port_cfg(jcfg)
    tx = jtrainer.make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    opt_state = tx.init(params)
    model = params_from_jax(tiny["params"], cfg.model)
    opt, sched = make_optimizer(cfg, model)
    rng = np.random.default_rng(0)
    for _ in range(n_steps):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-2, tiny["params"])
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, layer in model.layers.items():
            layer.weight.grad = torch.from_numpy(grads[name]["w"].T.copy())
            layer.bias.grad = torch.from_numpy(grads[name]["b"].copy())
        opt.step()
        sched.step()
    back = params_to_jax(model)
    for name in back:
        for k in ("w", "b"):
            np.testing.assert_allclose(back[name][k], np.asarray(params[name][k]),
                                       rtol=0, atol=1e-6, err_msg=f"{name}/{k}")
    # and the Adam state, in the JAX layout
    state = optimizer_state_to_jax(model, opt)
    assert state["count"] == n_steps == int(opt_state[0].count)
    for name in back:
        for k in ("w", "b"):
            np.testing.assert_allclose(state["mu"][name][k], np.asarray(opt_state[0].mu[name][k]),
                                       rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(state["nu"][name][k], np.asarray(opt_state[0].nu[name][k]),
                                       rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------


def _jax_state_after_updates(tiny, n=3):
    tx = tiny["tx"]
    params = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    opt_state = tx.init(params)
    rng = np.random.default_rng(1)
    for _ in range(n):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 1e-2), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state


def test_port_resumes_a_jax_checkpoint(tiny, tmp_path):
    """JAX saves params, optax's Adam state and the step; the port's trainer
    resumes all three, and its next update equals optax's."""
    params, opt_state = _jax_state_after_updates(tiny, 3)
    jckpt.save_checkpoint(str(tmp_path), 2, params, opt_state, extra={"loss": 0.5})
    with np.load(str(tmp_path / "model_000002.ckpt.npz")) as z:
        keys = set(z.files)
    assert {"opt//s:0//a:count", "opt//s:1//a:count", "opt//s:0//a:mu//d:fc1//d:w",
            "opt//s:0//a:nu//d:rgb2//d:b", "params//d:fc1//d:w", "step",
            "extra//loss"} <= keys
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path))
    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    assert trainer.try_resume() and trainer.start_iter == 3
    back = params_to_jax(trainer.model)
    state = optimizer_state_to_jax(trainer.model, trainer.optimizer)
    assert state["count"] == 3
    for name in back:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k], np.asarray(params[name][k]))
            np.testing.assert_array_equal(state["mu"][name][k],
                                          np.asarray(opt_state[0].mu[name][k]))
            np.testing.assert_array_equal(state["nu"][name][k],
                                          np.asarray(opt_state[0].nu[name][k]))
    # one more update on each side from the same grads
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-2, tiny["params"])
    updates, _ = tiny["tx"].update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
    want = optax.apply_updates(params, updates)
    for name, layer in trainer.model.layers.items():
        layer.weight.grad = torch.from_numpy(grads[name]["w"].T.copy())
        layer.bias.grad = torch.from_numpy(grads[name]["b"].copy())
    trainer.optimizer.step()
    got = params_to_jax(trainer.model)
    for name in got:
        np.testing.assert_allclose(got[name]["w"], np.asarray(want[name]["w"]), rtol=0, atol=1e-6)


def test_resume_restores_the_learning_rate(tiny, tmp_path):
    """A checkpoint taken past a decay boundary resumes at the decayed rate
    and decays again at the next boundary."""
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path),
                    train=dict(lrate_decay_steps=5, lrate_decay=0.1))
    a = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    for p in a.model.parameters():
        p.grad = torch.zeros_like(p)
    for _ in range(7):
        a.optimizer.step()
        a.scheduler.step()
    a.save(6, 0.0)
    b = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    assert b.try_resume() and b.start_iter == 7
    schedule = make_schedule(cfg)
    for p in b.model.parameters():
        p.grad = torch.zeros_like(p)
    for step in range(7, 12):
        np.testing.assert_allclose(b.optimizer.param_groups[0]["lr"], schedule(step), rtol=1e-12)
        b.optimizer.step()
        b.scheduler.step()


def test_jax_reads_a_port_checkpoint(tiny, tmp_path):
    """The port saves after real steps; the JAX package's load_checkpoint
    restores params, Adam state and step into its own templates, and the
    JAX trainer resumes from the file."""
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path),
                    train=dict(log_every=1, val_every=0, save_ckpt_iter=0))
    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    trainer.fit(max_iters=3, progress=False)
    path = str(tmp_path / "final_model.ckpt.npz")
    assert os.path.exists(path) and not glob.glob(str(tmp_path / "*.tmp*"))
    tx = tiny["tx"]
    template = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    params, opt_state, step = jckpt.load_checkpoint(path, template, tx.init(template))
    assert step == 2
    assert int(opt_state[0].count) == 3 and int(opt_state[1].count) == 3
    want = params_to_jax(trainer.model)
    state = optimizer_state_to_jax(trainer.model, trainer.optimizer)
    for name in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(params[name][k]), want[name][k])
            np.testing.assert_array_equal(np.asarray(opt_state[0].mu[name][k]),
                                          state["mu"][name][k])
            np.testing.assert_array_equal(np.asarray(opt_state[0].nu[name][k]),
                                          state["nu"][name][k])
    assert np.abs(state["nu"]["fc1"]["w"]).max() > 0
    with np.load(path) as z:
        assert np.isfinite(float(z["extra//loss"]))
    jcfg = dataclasses.replace(tiny["jcfg"], checkpoint_path=str(tmp_path))
    jt = jtrainer.NeRFTrainer(jcfg, tiny["images"], tiny["poses"], tiny["K"])
    assert jt.try_resume() and jt.start_iter == 3
    np.testing.assert_array_equal(np.asarray(jt.params["fc1"]["w"]), want["fc1"]["w"])


def test_optimizer_state_round_trip(tiny):
    params, opt_state = _jax_state_after_updates(tiny, 2)
    cfg = _port_cfg(tiny["jcfg"])
    model = params_from_jax(_np_tree(params), cfg.model)
    opt, _ = make_optimizer(cfg, model)
    state = {"count": 2, "mu": _np_tree(opt_state[0].mu), "nu": _np_tree(opt_state[0].nu)}
    optimizer_state_from_jax(model, opt, state)
    st = opt.state[model.layers["fc1"].weight]
    assert st["exp_avg"].shape == model.layers["fc1"].weight.shape       # (out, in)
    np.testing.assert_array_equal(st["exp_avg"].numpy(), state["mu"]["fc1"]["w"].T)
    assert float(st["step"]) == 2.0
    back = optimizer_state_to_jax(model, opt)
    assert back["count"] == 2
    for tree in ("mu", "nu"):
        for name in back[tree]:
            for k in ("w", "b"):
                np.testing.assert_array_equal(back[tree][name][k], state[tree][name][k])
    bad = {**state, "mu": {**state["mu"], "fc1": {"w": np.zeros((3, 3), np.float32),
                                                  "b": state["mu"]["fc1"]["b"]}}}
    with pytest.raises(ValueError):
        optimizer_state_from_jax(model, opt, bad)


def test_resume_picks_the_numerically_newest_step(tiny, tmp_path):
    """model_1000000 sorts before model_999999 as text; resume takes it."""
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path))
    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    for step in (999_999, 1_000_000):
        trainer.save(step, 0.0)
    trainer.save(5, 0.0, final=True)
    assert os.path.basename(tckpt.latest_checkpoint(str(tmp_path))) == "model_1000000.ckpt.npz"
    assert os.path.basename(tckpt.latest_checkpoint(str(tmp_path), prefer_final=True)) \
        == "final_model.ckpt.npz"
    assert trainer.try_resume() and trainer.start_iter == 1_000_001
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


ROUTES = {
    "merged": dict(use_fused_kernel=True, fused_merged_step=True),
    "two_kernel": dict(use_fused_kernel=True, fused_merged_step=False),
    "module": dict(use_fused_kernel=False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_fit_lowers_the_loss(tiny, tmp_path, route):
    """48 steps on the tiny set through each loss route (the fused wrappers
    run their plain versions on the CPU): the loss over every pixel of the
    set at the bin-midpoint depths falls by more than 3% (the images are
    noise: what can be learnt in 48 steps is their mean colour), every
    logged loss is finite, the cadences leave their checkpoints, and
    validation renders its views."""
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path), render=ROUTES[route],
                    train=dict(lrate=5e-3, log_every=2, save_ckpt_iter=20, val_every=40,
                               n_val_images=2))
    assert fused_train_supported(cfg) == (route != "module")
    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    n_img, height, width = tiny["images"].shape[:3]
    every = tuple(torch.from_numpy(a.reshape(-1)) for a in np.meshgrid(
        np.arange(n_img), np.arange(width), np.arange(height), indexing="ij"))
    whole_set = make_loss_fn(cfg, n_rays=n_img * height * width)

    def set_loss():
        with torch.no_grad():
            return float(whole_set(trainer.model, None, trainer.images, trainer.poses,
                                   trainer.K, draws=every))

    before = set_loss()
    stats = trainer.fit(max_iters=48, progress=False)
    losses = [v for _, v in trainer.loss_log]
    assert [it for it, _ in trainer.loss_log] == list(range(0, 48, 2))
    assert np.isfinite(losses).all()
    assert set_loss() < 0.97 * before
    assert stats["steps"] == 48 and stats["rays_per_sec"] > 0
    assert stats["final_loss"] == pytest.approx(float(trainer._loss))
    assert stats["ms_per_step"] > 0
    assert sorted(os.listdir(tmp_path)) == [
        "final_model.ckpt.npz", "model_000020.ckpt.npz", "model_000040.ckpt.npz"]
    assert [(it, v >= 0) for it, _, v in trainer.val_log] == [(40, True)] * 2
    # a second fit resumes from model_000040 and runs the rest only
    again = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    stats2 = again.fit(max_iters=44, progress=False)
    assert again.start_iter == 41 and stats2["steps"] == 3


def test_routes_agree_on_the_first_loss(tiny):
    """Same seed, same draws: the three routes' first losses agree to 1e-4
    relative, and the two fused routes' first grads to 1e-5 of the norm."""
    out = {}
    for route, kw in ROUTES.items():
        cfg = _port_cfg(tiny["jcfg"], render=kw)
        model = NeRF(cfg.model, seed=0)
        gen = torch.Generator().manual_seed(1)
        loss = make_loss_fn(cfg)(model, gen, *(torch.from_numpy(tiny[k])
                                               for k in ("images", "poses", "K")))
        loss.backward()
        out[route] = (float(loss.detach()), torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    for route in ("two_kernel", "module"):
        np.testing.assert_allclose(out[route][0], out["merged"][0], rtol=1e-4)
    ref = out["merged"][1]
    assert (out["two_kernel"][1] - ref).norm() <= 1e-5 * ref.norm()
    assert (out["module"][1] - ref).norm() <= 1e-3 * ref.norm()


def test_three_eager_steps_match_jax_xla_loss_under_optax(tiny):
    """The same drawn pixels and depths for three steps: the port's eager
    nn.Module step (Adam, StepLR) and the JAX XLA loss with optax.adam, both
    float32 from the same params, give the same losses to 1e-4 relative."""
    jcfg = tiny["jcfg"]
    cfg = _port_cfg(jcfg, render=dict(use_fused_kernel=False))
    model = params_from_jax(tiny["params"], cfg.model)
    opt, sched = make_optimizer(cfg, model)
    loss_fn = make_loss_fn(cfg)
    tx = jtrainer.make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    opt_state = tx.init(params)
    images, poses, K = (torch.from_numpy(tiny[k]) for k in ("images", "poses", "K"))
    n_img, height, width = tiny["images"].shape[:3]

    def xla_loss(p, o, d, z, target):
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        density, rgb = nerf_apply(p, pts, jnp.broadcast_to(d[:, None, :], pts.shape), jcfg.model)
        return jnp.mean((jcomposite(density, rgb, z, jcfg.render)[0] - target) ** 2)

    rng = np.random.default_rng(11)
    losses_t, losses_j = [], []
    for _ in range(3):
        draws = tuple(torch.from_numpy(rng.integers(0, hi, N_RAYS))
                      for hi in (n_img, width, height))
        u = torch.from_numpy(rng.uniform(size=(N_RAYS, cfg.render.n_sample)).astype(np.float32))
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, None, images, poses, K, draws=draws, u=u)
        loss.backward()
        opt.step()
        sched.step()
        losses_t.append(float(loss.detach()))
        o, d, target = sample_ray_batch(images, poses, K, N_RAYS, draws=draws)
        z = stratified_samples(N_RAYS, cfg.render, None, "cpu", u)
        lj, grads = jax.value_and_grad(xla_loss)(
            params, *(jnp.asarray(t.numpy()) for t in (o, d, z, target)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(lj))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[0] != losses_t[1]
    got = params_to_jax(model)
    for name in got:
        np.testing.assert_allclose(got[name]["w"], np.asarray(params[name]["w"]),
                                   rtol=0, atol=2e-5, err_msg=name)


def test_interrupt_saves_the_last_finished_step(tiny, tmp_path):
    """A KeyboardInterrupt raised inside the fifth step leaves a checkpoint
    stamped 3 (the last step whose update the params hold), holding those
    params; a new trainer resumes at 4."""
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path),
                    train=dict(log_every=0, val_every=0, save_ckpt_iter=0))
    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    inner, calls, held = trainer.train_step, [], {}

    def step(model, *args):
        if len(calls) == 4:
            held.update(params_to_jax(model))
            raise KeyboardInterrupt
        calls.append(1)
        return inner(model, *args)

    trainer.train_step = step
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(max_iters=10, progress=False)
    assert os.listdir(tmp_path) == ["model_000003.ckpt.npz"]
    params, opt_state, step_saved = tckpt.load_checkpoint(str(tmp_path / "model_000003.ckpt.npz"))
    assert step_saved == 3 and opt_state["count"] == 4
    np.testing.assert_array_equal(params["fc1"]["w"], held["fc1"]["w"])
    again = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu")
    assert again.try_resume() and again.start_iter == 4


# The trainer on the CPU in a child process (a SIGINT sent inside a
# pytest-xdist worker is not safe): an optimizer post-hook sends SIGINT to
# the process during the fifth update, as Ctrl-C can land there
_INTERRUPT_PROBE = r"""
import json, os, signal, sys
import numpy as np
import torch
from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig)
from sfm_nerf_tpu_torch.models.convert import params_to_jax
from sfm_nerf_tpu_torch.train import checkpoint as ckpt
from sfm_nerf_tpu_torch.train.nerf_trainer import NeRFTrainer

torch.set_num_threads(1)
ck, backend = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(0)
images = rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
poses[:, 2, 3] = 4.0
K = np.array([[20, 0, 8], [0, 20, 8], [0, 0, 1]], np.float32)
cfg = NeRFPipelineConfig(
    model=NeRFModelConfig(hidden=32, n_pos_freq=4, n_dir_freq=2),
    render=RenderConfig(n_sample=16, use_fused_kernel=True),
    train=TrainConfig(n_rays_batch=64, log_every=0, val_every=0, save_ckpt_iter=0,
                      ckpt_backend=backend),
    checkpoint_path=ck, load_checkpoint=False)
tr = NeRFTrainer(cfg, images, poses, K, device="cpu")
held = {}

def hook(opt, args, kwargs):
    n = int(next(iter(opt.state.values()))["step"])
    if n == 5:
        held["params"] = params_to_jax(tr.model)
        os.kill(os.getpid(), signal.SIGINT)

tr.optimizer.register_step_post_hook(hook)
try:
    tr.fit(max_iters=20, progress=False)
    raise SystemExit("fit ran to its end: no interrupt")
except KeyboardInterrupt:
    pass
assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
path = ckpt.latest_checkpoint(ck)
params, opt_state, step = ckpt.load_checkpoint(path)
same = all(np.array_equal(params[k][w], held["params"][k][w])
           for k in params for w in ("w", "b"))
again = NeRFTrainer(cfg, images, poses, K, device="cpu")
print(json.dumps({"files": sorted(os.listdir(ck)), "stamp": step,
                  "count": opt_state["count"], "params_equal": same,
                  "resumed": again.try_resume(), "start_iter": again.start_iter}))
"""


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_interrupt_during_the_update_saves_that_update(tmp_path, backend):
    """SIGINT inside optimizer.step() of the fifth step: the trainer holds it
    until the step is recorded as done, so the checkpoint is stamped 4 with
    Adam's count 5 (stamp = count - 1, as the JAX trainer's
    tests/test_interrupt.py:19 implies), holds the parameters after those 5
    updates, and a fresh trainer resumes at 5; the SIGINT handler is given
    back after fit.  Under both checkpoint backends."""
    import subprocess
    import sys

    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.path.abspath(repo), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _INTERRUPT_PROBE, str(tmp_path / "ck"), backend],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["files"] == ["model_000004.ckpt.npz"], got
    assert (got["stamp"], got["count"]) == (4, 5), got
    assert got["params_equal"], got
    assert got["resumed"] and got["start_iter"] == 5, got


def test_interrupt_before_any_step_saves_nothing(tiny, tmp_path):
    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path / "ck"))

    def step(*args):
        raise KeyboardInterrupt

    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu",
                          train_step=step)
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(max_iters=3, progress=False)
    assert not os.path.exists(tmp_path / "ck")


def test_the_loss_reaches_the_host_only_at_log_every(tiny, tmp_path):
    """The step returns a detached tensor and the loop converts it only at
    the log cadence; a writer, when given, gets the JAX trainer's tags."""
    class Writer:
        def __init__(self):
            self.scalars, self.images = [], []

        def add_scalar(self, tag, value, it):
            self.scalars.append((tag, it))

        def add_image(self, tag, img, it):
            self.images.append((tag, img.shape, it))

    cfg = _port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path),
                    train=dict(log_every=4, val_every=8, save_ckpt_iter=0, n_val_images=1))
    writer = Writer()
    trainer = NeRFTrainer(cfg, tiny["images"], tiny["poses"], tiny["K"], device="cpu",
                          writer=writer)
    opt, sched = trainer.optimizer, trainer.scheduler
    loss = make_train_step(cfg, opt, sched)(trainer.model, torch.Generator().manual_seed(0),
                                            trainer.images, trainer.poses, trainer.K)
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0 and not loss.requires_grad
    trainer.fit(max_iters=10, progress=False)
    assert [it for it, _ in trainer.loss_log] == [0, 4, 8]
    assert [s for s in writer.scalars if s[0] == "Loss/train"] == [
        ("Loss/train", 0), ("Loss/train", 4), ("Loss/train", 8)]
    assert {t for t, _ in writer.scalars} == {
        "Loss/train", "Learning Rate", "Loss/train_avg", "Loss/val_0"}
    assert writer.images == [("Val_Image_0", (3, 16, 32), 8)]


def test_unported_options_raise(tiny, tmp_path):
    """Options once unported.  The bf16 nn.Module path is ported: its loss
    and grads match JAX's bf16 XLA loss (tests/test_torch_interop.py's
    rule).  Hierarchical sampling is (tests/test_torch_hier_train.py): the
    trainer builds a coarse/fine pair for it.  The orbax backend is ported
    (train/async_ckpt.py, held by tests/test_torch_aux.py): the trainer
    takes it, and refuses a backend it does not know."""
    from sfm_nerf_tpu_torch.models.nerf import NeRFPair
    from sfm_nerf_tpu_torch.train.async_ckpt import AsyncCheckpointer
    from test_torch_interop import _bf16_case, assert_bf16_matches_jax

    args = (tiny["images"], tiny["poses"], tiny["K"])
    hier = NeRFTrainer(_port_cfg(tiny["jcfg"], render=dict(n_importance=8)), *args, device="cpu")
    assert isinstance(hier.model, NeRFPair)
    assert callable(make_loss_fn(_port_cfg(tiny["jcfg"], render=dict(n_importance=8))))
    assert callable(make_loss_fn(_port_cfg(tiny["jcfg"], train=dict(compute_dtype="bfloat16"))))
    assert_bf16_matches_jax(_bf16_case(hier=False, n_rays=N_RAYS))
    orbax = NeRFTrainer(_port_cfg(tiny["jcfg"], checkpoint_path=str(tmp_path),
                                  train=dict(ckpt_backend="orbax")), *args, device="cpu")
    assert isinstance(orbax._async, AsyncCheckpointer)
    with pytest.raises(ValueError, match="ckpt_backend"):
        NeRFTrainer(_port_cfg(tiny["jcfg"], train=dict(ckpt_backend="zarr")), *args,
                    device="cpu")


@pytest.mark.parametrize("change,supported", [
    (dict(), True),
    (dict(model=dict(arch="legacy")), True),
    (dict(model=dict(arch="legacy", pos_encoding=False, has_skip=False)), True),
    (dict(render=dict(white_background=True)), True),
    (dict(render=dict(n_sample=200)), True),          # no chunk-alignment clause
    (dict(render=dict(n_importance=128)), True),      # hierarchical: the merged step
    (dict(render=dict(n_importance=128, fused_merged_step=False)), False),
    (dict(render=dict(variant="legacy")), False),
    (dict(render=dict(use_fused_kernel=False)), False),
    (dict(model=dict(hidden=40)), False),
    (dict(model=dict(hidden=512)), False),
    (dict(model=dict(n_pos_freq=17)), False),
])
def test_fused_train_supported_envelope(change, supported):
    cfg = NeRFPipelineConfig(
        model=NeRFModelConfig(**change.get("model", {})),
        render=RenderConfig(**{"use_fused_kernel": True, **change.get("render", {})}))
    assert fused_train_supported(cfg) is supported
