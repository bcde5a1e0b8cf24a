"""The port's auxiliary modules against their JAX counterparts on the CPU:
utils/profiling.py (StepTimer, device_memory_stats, the trace and its
summary), utils/debug.py (the finite check, the NaN trap) and
train/async_ckpt.py (the ``ckpt_backend='orbax'`` writer), each fed the
same numpy inputs as the JAX function (tests/test_utils.py,
tests/test_train.py:154).

Sizes: the trainer cases are tests/test_torch_train.py's (hidden 32, 16x16
images, 64 rays x 16 samples).  Tolerances: none; timings are held to
tests/test_utils.py's bounds, checkpoints bit for bit.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.train import checkpoint as jckpt
from sfm_nerf_tpu.utils import debug as jdebug
from sfm_nerf_tpu.utils import profiling as jprof
from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.models.convert import optimizer_state_to_jax, params_to_jax
from sfm_nerf_tpu_torch.train import checkpoint as tckpt
from sfm_nerf_tpu_torch.train.async_ckpt import AsyncCheckpointer
from sfm_nerf_tpu_torch.train.nerf_trainer import NeRFTrainer
from sfm_nerf_tpu_torch.utils import debug as tdebug
from sfm_nerf_tpu_torch.utils import profiling as tprof
from util_synthetic import tiny_pipeline_setup


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_step_timer_separates_the_first_call_from_steady():
    """tests/test_utils.py:13's schedule through both timers: the same
    summary keys, the first call kept apart, the steady mean within its
    bounds."""
    timers = {"jax": jprof.StepTimer(), "torch": tprof.StepTimer("cpu")}
    for t in timers.values():
        with t:
            time.sleep(0.05)
        for _ in range(3):
            with t:
                time.sleep(0.01)
    sj, st = (timers[k].summary() for k in ("jax", "torch"))
    assert set(st) == set(sj)
    for s in (sj, st):
        assert s["compile_call_s"] >= 0.05
        assert 0.005 < s["steady_mean_s"] < 0.05 and 0.005 < s["steady_p50_s"] < 0.05
        assert s["n_steady"] == 3


def test_step_timer_without_a_card_refuses_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.StepTimer("cuda")
    assert tprof.StepTimer("cpu").summary()["n_steady"] == 0


def test_device_memory_stats_shape():
    """A dict of at least one device, as the JAX function's
    (tests/test_utils.py:54); without a card the CPU's entry is empty, with
    one every card reports the three byte counts."""
    ours, theirs = tprof.device_memory_stats(), jprof.device_memory_stats()
    assert isinstance(ours, dict) and len(ours) >= 1 and len(theirs) >= 1
    if not torch.cuda.is_available():
        assert ours == {"cpu": {}}
    for stats in ours.values():
        assert set(stats) in (set(), {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"})


def test_trace_and_its_summary_on_the_cpu(tmp_path):
    """A CPU profile of a few matmuls: the Chrome trace is written, the
    summary has every key, its shares lie in [0, 1] and sum to 1, and a
    CPU run has no device time (no kernels, idle share 1)."""
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        for _ in range(5):
            a = torch.tanh(a @ a)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    s = tprof.profile_summary(prof)
    assert set(s) == {"window_ms", "device_busy_ms", "busy_share", "idle_share", "device_ms",
                      "n_device_events", "top_kernels"}
    assert 0.0 <= s["busy_share"] <= 1.0 and 0.0 <= s["idle_share"] <= 1.0
    assert s["busy_share"] + s["idle_share"] == pytest.approx(1.0)
    assert s["window_ms"] > 0
    if not torch.cuda.is_available():
        assert (s["device_busy_ms"], s["n_device_events"], s["top_kernels"]) == (0.0, 0, [])


def test_busy_time_is_the_union_of_intervals():
    """Overlapping and nested intervals count once, gaps not at all."""
    assert tprof._union_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert tprof._union_us([]) == 0


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree,bad_path", [
    ({"a": np.ones(3)}, None),
    ({"a": np.asarray([1.0, np.nan])}, "['a']"),
    ({"p": {"fc1": {"w": np.ones((2, 2)), "b": np.asarray([np.inf, 0.0])}}}, "['p']['fc1']['b']"),
    ({"xs": [np.zeros(2), np.asarray([-np.inf])]}, "['xs'][1]"),
    ({"step": np.asarray(3), "loss": np.asarray(0.5)}, None),
])
def test_assert_all_finite_names_the_path_as_jax_does(tree, bad_path):
    """The same numpy trees (torch tensors on the port's side): both pass,
    or both raise FloatingPointError with the same message."""
    as_torch = jax.tree_util.tree_map(torch.from_numpy, tree)
    as_jax = jax.tree_util.tree_map(jnp.asarray, tree)
    if bad_path is None:
        tdebug.assert_all_finite(as_torch, "ok")
        jdebug.assert_all_finite(as_jax, "ok")
        return
    with pytest.raises(FloatingPointError) as ours:
        tdebug.assert_all_finite(as_torch, "bad")
    with pytest.raises(FloatingPointError) as theirs:
        jdebug.assert_all_finite(as_jax, "bad")
    assert str(ours.value) == str(theirs.value) == f"non-finite values in bad at {bad_path}"


def test_nan_debugging_traps_a_nan_backward_and_restores():
    """Inside the context a backward that makes a NaN raises (sqrt'(−1));
    after it the previous setting is back, and the same backward passes
    silently; JAX's context traps its NaN the same way
    (tests/test_utils.py:34)."""
    prev = torch.is_anomaly_enabled()
    x = torch.tensor(-1.0, requires_grad=True)
    with tdebug.nan_debugging():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    assert torch.is_anomaly_enabled() == prev
    torch.sqrt(x).backward()
    assert torch.isnan(x.grad)
    tdebug.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        tdebug.enable_nan_debugging(prev)
    jprev = jax.config.jax_debug_nans
    with jdebug.nan_debugging():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda v: jnp.log(v))(jnp.asarray(-1.0)).block_until_ready()
    assert jax.config.jax_debug_nans == jprev


# ---------------------------------------------------------------------------
# the async checkpoint backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg, tx, params, _, images, poses, K = tiny_pipeline_setup(n_rays=64)
    return dict(jcfg=jcfg, tx=tx, params=params, images=np.array(images),
                poses=np.array(poses), K=np.array(K))


def _cfg(tmp_path, **train):
    return NeRFPipelineConfig(
        model=NeRFModelConfig(hidden=32, n_pos_freq=4, n_dir_freq=2),
        render=RenderConfig(n_sample=16, use_fused_kernel=True),
        train=TrainConfig(n_rays_batch=64, log_every=0, val_every=0, **train),
        checkpoint_path=str(tmp_path / "ck"), load_checkpoint=False)


def test_orbax_backend_roundtrip_and_resume(tiny, tmp_path):
    """tests/test_train.py:154 on the port: ckpt_backend='orbax' saves at 5
    and 10 (the final save, stamped 10, is the cadence one: idempotent),
    every file commits before fit returns, a new trainer resumes at 11 with
    the parameters bit for bit and keeps training; the JAX package's npz
    loader reads the port's async file into its own templates."""
    args = (tiny["images"], tiny["poses"], tiny["K"])
    cfg = _cfg(tmp_path, ckpt_backend="orbax", save_ckpt_iter=5)
    trainer = NeRFTrainer(cfg, *args, device="cpu")
    trainer.fit(max_iters=11, progress=False)
    assert trainer._async.latest_step() == 10
    assert sorted(os.listdir(cfg.checkpoint_path)) == ["model_000005.ckpt.npz",
                                                       "model_000010.ckpt.npz"]
    want = params_to_jax(trainer.model)
    again = NeRFTrainer(dataclasses.replace(cfg, load_checkpoint=True), *args, device="cpu")
    assert again.try_resume() and again.start_iter == 11
    got = params_to_jax(again.model)
    for name in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[name][k], want[name][k])
    assert again.fit(max_iters=16, progress=False)["steps"] == 5
    path = os.path.join(cfg.checkpoint_path, "model_000010.ckpt.npz")
    template = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    params, opt_state, step = jckpt.load_checkpoint(path, template, tiny["tx"].init(template))
    assert step == 10 and int(opt_state[0].count) == 11
    state = optimizer_state_to_jax(trainer.model, trainer.optimizer)
    for name in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(params[name][k]), want[name][k])
            np.testing.assert_array_equal(np.asarray(opt_state[0].nu[name][k]),
                                          state["nu"][name][k])


def test_async_checkpointer_contract(tmp_path):
    """The JAX class's contract on its own: an idempotent save of a step
    that exists (the second call writes nothing), latest_step, restore of
    the newest or a given step, wait, close; restore with nothing saved
    raises FileNotFoundError.  The file is the npz checkpoint.py reads."""
    ck = AsyncCheckpointer(str(tmp_path / "a"))
    with pytest.raises(FileNotFoundError):
        ck.restore()
    assert ck.latest_step() is None
    params = {"fc1": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}}
    opt = {"count": 4, "mu": {"fc1": {"w": torch.zeros(2, 3), "b": torch.zeros(3)}},
           "nu": {"fc1": {"w": torch.full((2, 3), 2.0), "b": torch.zeros(3)}}}
    path = ck.save(3, params, opt, extra={"loss": torch.tensor(0.25)})
    ck.wait()
    first = os.stat(path).st_mtime_ns
    changed = {"fc1": {"w": torch.zeros(2, 3), "b": torch.zeros(3)}}
    assert ck.save(3, changed, opt) == path
    ck.save(7, changed, opt)
    ck.close()
    assert os.stat(path).st_mtime_ns == first and ck.latest_step() == 7
    p3, o3, s3 = ck.restore(3)
    np.testing.assert_array_equal(p3["fc1"]["w"], np.arange(6.0).reshape(2, 3))
    assert (s3, o3["count"]) == (3, 4)
    np.testing.assert_array_equal(o3["nu"]["fc1"]["w"], np.full((2, 3), 2.0))
    with np.load(path) as z:
        assert float(z["extra//loss"]) == 0.25
    assert ck.restore()[2] == 7 and tckpt.load_checkpoint(path)[2] == 3
    assert AsyncCheckpointer(str(tmp_path / "a")).latest_step() == 7
