"""The port's multi-device NeRF training and rendering (parallel/) against
the JAX package's (tests/test_parallel.py) on the CPU.

The JAX side runs here on 4 of conftest's virtual CPU devices.  The port
runs in gloo process groups of CPU ranks (tests/torch_parallel_worker.py,
which imports no jax): one group of 4 ranks runs every step and frame
check, one of 2 ranks a trainer fit.  Each rank of the port is fed the
draws the matching JAX device makes (``fold_in(key, i)`` then ``split``:
pixels, depths, importance jitter), so both packages see the same numbers.
Sizes: hidden 32 (40 for the out-of-envelope route), 4/2 frequencies,
12x12 images, 128 rays x 16 samples (+ 8 importance), a 17x13 frame (221
rays: the 4-way split pads 3).

Tolerances: a step's loss rtol 1e-5 and the parameters after one Adam step
rtol 1e-4, atol 1e-6 (tests/test_parallel.py:98-106); the sharded frame
against the same package's one-device frame rtol 2e-5, atol 2e-6 (:183),
against JAX's sharded frame 1e-5 (nn.Module) and 5e-3 (the fused route's
bf16 packing: tests/test_torch_hier_train.py's frame rule).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JModel
from sfm_nerf_tpu.config import NeRFPipelineConfig as JPipe
from sfm_nerf_tpu.config import ParallelConfig as JPar
from sfm_nerf_tpu.config import RenderConfig as JRender
from sfm_nerf_tpu.config import TrainConfig as JTrain
from sfm_nerf_tpu.models import init_nerf_params
from sfm_nerf_tpu.parallel import make_mesh as jmake_mesh
from sfm_nerf_tpu.parallel.render import make_sharded_render_image as jsharded_render
from sfm_nerf_tpu.parallel.train_step import (
    make_dp_train_step as jdp_step, make_spmd_train_step as jspmd_step,
    mlp_param_shardings,
)
from sfm_nerf_tpu.train import checkpoint as jckpt
from sfm_nerf_tpu.train.nerf_trainer import make_optimizer as jmake_optimizer

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
MODEL = dict(hidden=32, n_pos_freq=4, n_dir_freq=2)
ODD_HIDDEN = 40              # outside the kernels' envelope (not a multiple of 16)
N_IMG, HW, N_RAYS, S, NI = 3, 12, 128, 16, 8
FRAME_HW = (17, 13)
WORLD = 4
STEP_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
FRAME_RTOL, FRAME_ATOL = 2e-5, 2e-6
INTERP = dict(use_fused_kernel=True, fused_interpret=True, fused_sample_chunk=16,
              fused_ray_tile=4, fused_tiles_per_program=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jcfg(n_importance=0, tp=1, fused=True, hidden=MODEL["hidden"]):
    render = dict(n_sample=S, n_importance=n_importance, **(INTERP if fused else {}))
    return JPipe(model=JModel(**{**MODEL, "hidden": hidden}), render=JRender(**render),
                 train=JTrain(n_rays_batch=N_RAYS), parallel=JPar(tp=tp))


def _rank_draws(key, world, n_importance=0, fused=True):
    """What device i of a JAX dp/spmd step draws: fold_in(key, i) -> split
    -> (pixel draws; depth jitter; importance jitter)."""
    n = N_RAYS // world
    out = []
    for i in range(world):
        ks, kr = jax.random.split(jax.random.fold_in(key, i))
        ki, kx, ky = jax.random.split(ks, 3)
        draws = [np.asarray(jax.random.randint(k, (n,), 0, hi))
                 for k, hi in ((ki, N_IMG), (kx, HW), (ky, HW))]
        d = {"draws": draws}
        if fused:
            kz, kpdf = jax.random.split(kr)
            d["u"] = np.asarray(jax.random.uniform(kz, (n, S)))
            if n_importance:
                d["u_pdf"] = np.asarray(jax.random.uniform(kpdf, (n, n_importance),
                                                           dtype=jnp.float32))
        else:
            d["u"] = np.asarray(jax.random.uniform(kr, (n, S)))
        out.append(d)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp, case, world, env=None, timeout=240):
    """``world`` worker processes over one gloo group; their results, rank
    order.  A rank that fails or outlives ``timeout`` fails the test."""
    os.makedirs(tmp, exist_ok=True)
    case_file = os.path.join(tmp, "case.pt")
    torch.save(case, case_file)
    port = _free_port()
    child_env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    child_env.update(OMP_NUM_THREADS="1", **(env or {}))
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, case_file, str(r), str(world),
                               str(port), tmp], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=child_env)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank outlived {timeout} s")
    finally:
        for p in procs:
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n{text[-4000:]}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _assert_params_close(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL, where=""):
    assert set(got) == set(want)
    for name in want:
        if "w" not in want[name]:
            _assert_params_close(got[name], want[name], rtol, atol, f"{name}/")
            continue
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(got[name][k]), np.asarray(want[name][k]),
                                       rtol=rtol, atol=atol, err_msg=f"{where}{name}/{k}")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (N_IMG, HW, HW, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (N_IMG, 1, 1))
    poses[:, 0, 3] = np.linspace(-0.5, 0.5, N_IMG)
    poses[:, 2, 3] = 4.0
    focal = 0.5 * 0.6911 * HW / np.tan(0.5 * 0.6911)
    K = np.array([[focal, 0, HW / 2], [0, focal, HW / 2], [0, 0, 1]], np.float32)
    key0 = jax.random.key(0)
    params = {
        "flat": _np_tree(init_nerf_params(key0, JModel(**MODEL))),
        "pair": {"coarse": _np_tree(init_nerf_params(key0, JModel(**MODEL))),
                 "fine": _np_tree(init_nerf_params(jax.random.fold_in(key0, 1),
                                                   JModel(**MODEL)))},
        "odd": _np_tree(init_nerf_params(jax.random.key(3),
                                         JModel(**{**MODEL, "hidden": ODD_HIDDEN}))),
    }
    frame_pose = np.eye(4, dtype=np.float32)
    frame_pose[2, 3] = 4.0
    return dict(images=images, poses=poses, K=K, params=params, frame_pose=frame_pose)


@pytest.fixture(scope="module")
def jax_side(scene):
    """JAX's dp steps on a 4-device mesh, its dp2 x tp2 fused step, its
    sharded frames, and the per-device draws each of them made."""
    devs = jax.devices()[:WORLD]
    mesh4 = jmake_mesh(dp=WORLD, tp=1, devices=devs)
    args = tuple(jnp.asarray(scene[k]) for k in ("images", "poses", "K"))
    out = {"draws": {}}
    cases = (("dp_module", "flat", _jcfg(fused=False), jax.random.key(42), False, 0),
             ("dp_fused", "flat", _jcfg(), jax.random.key(43), True, 0),
             ("dp_pair", "pair", _jcfg(n_importance=NI), jax.random.key(44), True, NI))
    for name, kind, cfg, key, fused, ni in cases:
        # the XLA route in float32, as the package runs outside these tests
        # (conftest's x64 would lift it to float64 through its linspace)
        with jax.enable_x64(fused):
            tx = jmake_optimizer(cfg)
            p = _jtree(scene["params"][kind])
            new, _, loss = jdp_step(cfg, tx, mesh4)(p, tx.init(p), key, *args)
            out[name] = (float(loss), _np_tree(new))
            out["draws"][name] = _rank_draws(key, WORLD, ni, fused)
    # dp2 x tp2: params stored model-sharded, the fused loss over all 4
    cfg = _jcfg(tp=2)
    mesh22 = jmake_mesh(dp=2, tp=2, devices=devs)
    tx = jmake_optimizer(cfg)
    p = jax.device_put(_jtree(scene["params"]["flat"]),
                       mlp_param_shardings(_jtree(scene["params"]["flat"]), mesh22))
    key = jax.random.key(9)
    new, _, loss = jspmd_step(cfg, tx, mesh22, p)(p, tx.init(p), key, *args)
    out["spmd"] = (float(loss), _np_tree(new))
    out["draws"]["spmd"] = _rank_draws(key, WORLD)
    out["shardings"] = {
        kind: jax.tree_util.tree_map(
            lambda s: tuple(s.spec), mlp_param_shardings(_jtree(scene["params"][kind]), mesh22),
            is_leaf=lambda x: hasattr(x, "spec"))
        for kind in ("flat", "pair")}
    # the module route of the dp2 x tp2 step: 2 data ranks of 64 rays
    rng = np.random.default_rng(7)
    out["draws"]["spmd_module"] = [
        {"draws": [rng.integers(0, hi, N_RAYS // 2) for hi in (N_IMG, HW, HW)],
         "u": rng.uniform(size=(N_RAYS // 2, S)).astype(np.float32)} for _ in range(2)]
    h, w = FRAME_HW
    for name, kind, cfg in (("render_fused", "flat", _jcfg()),
                            ("render_pair", "pair", _jcfg(n_importance=NI)),
                            ("render_module", "flat", _jcfg(fused=False))):
        out[name] = np.asarray(jsharded_render(cfg, mesh4)(
            _jtree(scene["params"][kind]), args[2], jnp.asarray(scene["frame_pose"]), h, w))
    return out


@pytest.fixture(scope="module")
def ranks(scene, jax_side, tmp_path_factory):
    """The 4-rank group's results (2 nodes of 2 ranks for the multi-node
    mesh)."""
    case = dict(task="nerf", images=scene["images"], poses=scene["poses"], K=scene["K"],
                params=scene["params"], frame_pose=scene["frame_pose"], frame_hw=FRAME_HW,
                model=MODEL, render=dict(n_sample=S), train=dict(n_rays_batch=N_RAYS),
                n_importance=NI, odd_hidden=ODD_HIDDEN, draws=jax_side["draws"])
    return _spawn(str(tmp_path_factory.mktemp("nerf_ranks")), case, WORLD,
                  env={"LOCAL_WORLD_SIZE": "2"})


@pytest.mark.parametrize("name", ["dp_module", "dp_fused", "dp_pair"])
def test_dp_step_matches_jax(ranks, jax_side, name):
    """One dp step over 4 ranks, each on its JAX device's draws: the loss
    and the parameters after Adam equal JAX's make_dp_train_step on a
    4-device mesh (:76 nn.Module, :492 fused flat, :518 fused pair)."""
    loss, params = jax_side[name]
    r0 = ranks[0][name]
    np.testing.assert_allclose(r0["loss"], loss, rtol=STEP_RTOL)
    _assert_params_close(r0["params"], params)


@pytest.mark.parametrize("name", ["dp_module", "dp_fused", "dp_pair"])
def test_dp_step_matches_its_one_rank_replay(ranks, name):
    """The dp step equals one process averaging the 4 ranks' losses on
    their draws; every rank ends with the same parameters and loss, and
    rank i drew as linearised position i."""
    loss, params = ranks[0][name]["replay"]
    for r, res in enumerate(ranks):
        assert res[name]["draw_index"] == r
        np.testing.assert_allclose(res[name]["loss"], loss, rtol=STEP_RTOL)
        _assert_params_close(res[name]["params"], params)
        _assert_params_close(res[name]["params"], ranks[0][name]["params"], rtol=0, atol=0)


def test_multihost_mesh_step_equals_the_flat_one(ranks):
    """make_multihost_mesh at 2 nodes x 2 ranks (LOCAL_WORLD_SIZE=2) is
    (dcn 2, data 2, model 1); its dp step reduces over (dcn, data) and, on
    the same draws by linearised position, equals the flat 4-rank step
    (tests/test_parallel.py:212, :249)."""
    for r, res in enumerate(ranks):
        m = res["multihost"]
        assert m["shape"] == {"dcn": 2, "data": 2, "model": 1}
        assert m["draw_index"] == r
        np.testing.assert_allclose(m["loss"], res["dp_fused"]["loss"], rtol=1e-6)
        _assert_params_close(m["params"], res["dp_fused"]["params"], rtol=2e-5, atol=1e-7)


def _canon_jax(spec, key):
    """A JAX spec of a (in, out) weight or a bias -> the torch dim sharded
    over 'model' (None: replicated)."""
    spec = tuple(spec) + (None,) * (2 - len(spec))
    if "model" not in spec:
        return None
    d = spec.index("model")
    return 1 - d if key == "w" else d


def _canon_port(placements):
    shard = [p for p in placements if p.startswith("Shard")]
    return None if not shard else int(shard[0].split("=")[1].rstrip(")"))


def test_param_placements_match_jax_layout(ranks, jax_side):
    """mlp_param_placements covers the tree and shards the same dimension
    of every layer as JAX's mlp_param_shardings, a pair per network
    (tests/test_parallel.py:130); the data axis always replicates."""
    got = {"flat": ranks[0]["spmd"]["placements"], "pair": ranks[0]["placements_pair"]}
    for kind in ("flat", "pair"):
        want = jax_side["shardings"][kind]
        trees = [(got[kind], want)] if kind == "flat" else \
            [(got[kind][s], want[s]) for s in ("coarse", "fine")]
        sharded = 0
        for g, w in trees:
            assert set(g) == set(w)
            for layer in w:
                for key in ("w", "b"):
                    assert g[layer][key][0] == "Replicate()"
                    assert _canon_port(g[layer][key]) == _canon_jax(w[layer][key], key), \
                        (kind, layer, key)
                    sharded += _canon_port(g[layer][key]) is not None
        assert sharded > 0
    # each rank holds half of a sharded weight, all of a replicated one
    for layer, (local, full) in ranks[0]["spmd"]["shapes"].items():
        d = _canon_port(got["flat"][layer]["w"])
        want = list(full)
        if d is not None:
            want[d] //= 2
        assert local == tuple(want), layer


def test_spmd_step_matches_jax_and_its_replay(ranks, jax_side):
    """dp2 x tp2 inside the fused envelope: parameters stored sharded, the
    fused loss over all 4 ranks on each rank's JAX draws: equal to JAX's
    make_spmd_train_step and to the port's one-process replay (:590); the
    gathered parameters are the same on every rank."""
    loss, params = jax_side["spmd"]
    rloss, rparams = ranks[0]["spmd"]["replay"]
    for r, res in enumerate(ranks):
        s = res["spmd"]
        assert s["draw_index"] == r and not s["warned"]
        np.testing.assert_allclose(s["loss"], loss, rtol=STEP_RTOL)
        np.testing.assert_allclose(s["loss"], rloss, rtol=STEP_RTOL)
        _assert_params_close(s["params"], params)
        _assert_params_close(s["params"], rparams)


def test_spmd_out_of_envelope_warns_and_matches_its_replay(ranks):
    """Fused requested at hidden 40 (outside the kernels' envelope): the
    builder warns once (:621) and runs the nn.Module on DTensors, rays on
    'data', weights on 'model'; the two ranks of a data row share its draws
    and the step equals the replay over the 2 data ranks."""
    rloss, rparams = ranks[0]["spmd_module"]["replay"]
    for r, res in enumerate(ranks):
        s = res["spmd_module"]
        assert len(s["warned"]) == 1 and "fused envelope" in s["warned"][0]
        assert s["draw_index"] == r // 2
        np.testing.assert_allclose(s["loss"], rloss, rtol=STEP_RTOL)
        _assert_params_close(s["params"], rparams)


@pytest.mark.parametrize("name", ["render_fused", "render_pair", "render_module"])
def test_sharded_frame_matches_single_device_and_jax(ranks, jax_side, name):
    """An odd 17x13 frame split over 4 ranks (3 padded rays): the same on
    every rank, equal to the one-device renderer's frame, and to JAX's
    make_sharded_render_image (:171, :545, :565)."""
    single = ranks[0][name]["single"]
    assert single.shape == (*FRAME_HW, 3)
    for res in ranks:
        np.testing.assert_array_equal(res[name]["image"], ranks[0][name]["image"])
    img = ranks[0][name]["image"]
    np.testing.assert_allclose(img, single, rtol=FRAME_RTOL, atol=FRAME_ATOL)
    atol = 1e-5 if name == "render_module" else 5e-3
    np.testing.assert_allclose(img, jax_side[name], rtol=0, atol=atol)
    assert img.max() > 0.05


def test_sharded_frame_with_a_generator(ranks):
    """Perturbed: each rank draws from its own fold of the generator; the
    frame is finite, in [0, 1], differs from the deterministic frame, and
    is the same on every rank."""
    img = ranks[0]["render_keyed"]["image"]
    assert img.shape == (*FRAME_HW, 3) and np.isfinite(img).all()
    assert img.min() >= 0 and img.max() <= 1
    assert np.abs(img - ranks[0]["render_fused"]["image"]).max() > 1e-4
    for res in ranks:
        np.testing.assert_array_equal(res["render_keyed"]["image"], img)


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("dp_ckpt"))
    case = dict(task="trainer", images=scene["images"], poses=scene["poses"], K=scene["K"],
                model=MODEL, render=dict(n_sample=S, use_fused_kernel=True),
                train=dict(n_rays_batch=N_RAYS, lrate=5e-3, log_every=1, save_ckpt_iter=4,
                           val_every=5, n_val_images=1),
                checkpoint_path=ck, max_iters=7,
                checkpoint_path_tp=str(tmp_path_factory.mktemp("tp_ckpt")), tp_iters=(4, 6),
                checkpoint_path_int=str(tmp_path_factory.mktemp("tp_int_ckpt")),
                interrupt_at=5)
    return ck, case["checkpoint_path_tp"], _spawn(
        str(tmp_path_factory.mktemp("trainer_ranks")), case, 2)


def test_trainer_fit_over_two_ranks(trained, scene):
    """NeRFTrainer in a 2-rank group trains data parallel: both ranks end
    with the same parameters, draw from their own streams, rank 0 alone
    logs and validates, one checkpoint set is written, and the JAX
    package's checkpoint.py reads the final one back as rank 0's params."""
    ck, _, res = trained
    assert [r["mesh"] for r in res] == [{"data": 2, "model": 1}] * 2
    assert [r["draw_index"] for r in res] == [0, 1]
    _assert_params_close(res[1]["params"], res[0]["params"], rtol=0, atol=0)
    assert [it for it, _ in res[0]["loss_log"]] == list(range(7))
    assert res[1]["loss_log"] == [] and res[1]["val_log"] == []
    assert [it for it, _, _ in res[0]["val_log"]] == [5]
    assert res[0]["stats"]["steps"] == res[1]["stats"]["steps"] == 7
    assert res[0]["stats"]["final_loss"] == res[1]["stats"]["final_loss"]
    assert sorted(os.listdir(ck)) == ["final_model.ckpt.npz", "model_000004.ckpt.npz"]
    template = _jtree(scene["params"]["flat"])
    tx = jmake_optimizer(_jcfg())
    params, opt_state, step = jckpt.load_checkpoint(
        os.path.join(ck, "final_model.ckpt.npz"), template, tx.init(template))
    assert step == 6 and int(opt_state[0].count) == 7
    _assert_params_close(_np_tree(params), res[0]["params"], rtol=0, atol=0)


def test_cli_dp_larger_than_the_world_exits_nonzero(tmp_path):
    """--dp 2 outside torchrun (a world of one) exits non-zero before it
    reads any data."""
    from sfm_nerf_tpu_torch.cli.nerf import main

    with pytest.raises(SystemExit) as e:
        main(["--mode", "train", "--device", "cpu", "--dp", "2",
              "--data_path", str(tmp_path / "none") + "/"])
    assert "--dp 2" in str(e.value.code) and "torchrun" in str(e.value.code)


def test_trainer_refuses_dp_without_a_process_group(scene):
    """ParallelConfig(dp=2) with no process group is an error, never a
    silent one-device run."""
    from sfm_nerf_tpu_torch.config import (
        NeRFModelConfig, NeRFPipelineConfig, ParallelConfig,
    )
    from sfm_nerf_tpu_torch.train.nerf_trainer import NeRFTrainer

    cfg = NeRFPipelineConfig(model=NeRFModelConfig(**MODEL), parallel=ParallelConfig(dp=2))
    with pytest.raises(ValueError, match="torchrun"):
        NeRFTrainer(cfg, scene["images"], scene["poses"], scene["K"], device="cpu")


def test_a_process_group_that_cannot_start_exits_nonzero(tmp_path):
    """Under a launcher's environment (WORLD_SIZE 2) whose rendezvous is
    incomplete (no MASTER_PORT), train mode fails; it does not fall back to
    one rank."""
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_PORT", "MASTER_ADDR")}
    env.update(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0", PYTHONPATH=os.path.join(
        os.path.dirname(WORKER), ".."))
    out = subprocess.run(
        [sys.executable, "-m", "sfm_nerf_tpu_torch.cli.nerf", "--mode", "train",
         "--device", "cpu", "--data_path", str(tmp_path / "none") + "/"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "MASTER" in out.stderr and "Loading data" not in out.stdout


def test_trainer_with_tp_stores_shards_and_writes_whole_checkpoints(trained, scene):
    """ParallelConfig(tp=2) over 2 ranks routes to the dp x tp step
    (tests/test_parallel.py:539): the parameters are stored sharded, the
    checkpoints hold whole tensors (JAX reads them), a second trainer
    resumes into the shards and runs the remaining steps, validation renders
    from the gathered weights on rank 0 alone; both ranks always agree."""
    _, ck, res = trained
    for r in res:
        fit0, fit1 = r["tp"]
        assert fit0["sharded"] and fit0["mesh"] == {"data": 1, "model": 2}
        assert (fit0["start_iter"], fit0["steps"]) == (0, 4)
        assert (fit1["start_iter"], fit1["steps"]) == (4, 2)
        _assert_params_close(fit1["params"], res[0]["tp"][1]["params"], rtol=0, atol=0)
    assert [it for it, _, _ in res[0]["tp"][1]["val_log"]] == [5]
    assert res[1]["tp"][1]["val_log"] == []
    assert sorted(os.listdir(ck)) == ["final_model.ckpt.npz", "model_000004.ckpt.npz"]
    template = _jtree(scene["params"]["flat"])
    tx = jmake_optimizer(_jcfg())
    params, opt_state, step = jckpt.load_checkpoint(
        os.path.join(ck, "final_model.ckpt.npz"), template, tx.init(template))
    assert step == 5 and int(opt_state[0].count) == 6
    _assert_params_close(_np_tree(params), res[0]["tp"][1]["params"], rtol=0, atol=0)


def test_interrupt_under_tp_saves_shards_and_resumes(trained, scene):
    """dp1 x tp2, SIGINT on both ranks inside the fifth update: each rank
    holds it until the step is recorded, then writes its own shards stamped
    4 (no collective: the other rank may be anywhere); a new trainer puts
    them back together (the stamps agree), writes them as a whole
    checkpoint, which the JAX package reads, and resumes at 5 with the
    parameters of the one-process replay of those 5 steps (the replay's
    tolerances, PARAM_RTOL / PARAM_ATOL)."""
    _, _, res = trained
    for r in res:
        got = r["tp_interrupt"]
        assert got["interrupted"] and got["resumed"] and got["start_iter"] == 5
        assert got["files_after_interrupt"] == ["shard_rank0_of2.npz", "shard_rank1_of2.npz"]
        assert got["files_after_resume"] == ["model_000004.ckpt.npz", "shard_rank0_of2.npz",
                                             "shard_rank1_of2.npz"]
        _assert_params_close(got["params"], res[0]["tp_interrupt"]["replay"])
    _assert_params_close(res[1]["tp_interrupt"]["params"], res[0]["tp_interrupt"]["params"],
                         rtol=0, atol=0)
    template = _jtree(scene["params"]["flat"])
    tx = jmake_optimizer(_jcfg())
    params, opt_state, step = jckpt.load_checkpoint(
        os.path.join(res[0]["tp_interrupt"]["ckpt_dir"], "model_000004.ckpt.npz"),
        template, tx.init(template))
    assert step == 4 and int(opt_state[0].count) == 5
    _assert_params_close(_np_tree(params), res[0]["tp_interrupt"]["params"], rtol=0, atol=0)
