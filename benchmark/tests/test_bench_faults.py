"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and when the control (the reference
in a lower precision) stands in the program's place; a sound run comes
out true.  Whole runs at small sizes on the CPU, the card's look skipped.
The readings at the cells' own sizes are the card's (``calibrate.py``,
and the ``gpu`` test at the end)."""

import pytest
import torch

from benchmark import calibrate, compare, harness
from benchmark.tests import tiny

NT = "sfm_nerf_tpu_torch.train.nerf_trainer"
TRAIN_CELLS = ["flat-train", "hier-train", "flat-train-wrapper"]


def _nt():
    import importlib

    return importlib.import_module(NT)


def _half(t):
    return t[: t.shape[0] // 2]


def unchanged_state(monkeypatch, cell):
    """A step that computes its loss and grads and returns the model
    unchanged."""
    nt = _nt()

    def make_train_step(cfg, optimizer, scheduler, guard=None):
        loss_fn = nt.make_loss_fn(cfg)

        def step(model, generator, images, poses, K):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, generator, images, poses, K)
            loss.backward()
            return loss.detach()
        return step
    monkeypatch.setattr(nt, "make_train_step", make_train_step)


def half_batch(monkeypatch, cell):
    """Half of each batch left out of the loss, the mean over the rest."""
    nt = _nt()
    if cell == "flat-train-wrapper":
        monkeypatch.setattr(nt, "_mse", lambda p, t: torch.mean((_half(p) - _half(t)) ** 2))
        return
    k2, k4 = nt.fused_mse_loss, nt.fused_mse_loss_weights
    monkeypatch.setattr(nt, "fused_mse_loss", lambda pk, o, d, z, t, r: k2(
        pk, _half(o), _half(d), _half(z), _half(t), r))
    monkeypatch.setattr(nt, "fused_mse_loss_weights", lambda pk, o, d, z, t, r: (
        k4(pk, _half(o), _half(d), _half(z), _half(t), r)[0], k4(pk, o, d, z, t, r)[1]))


def altered_loss(monkeypatch, cell):
    """The step's answer altered where it is produced: the loss, and with
    it every grad, 10% high."""
    nt = _nt()
    if cell == "flat-train-wrapper":
        mse = nt._mse
        monkeypatch.setattr(nt, "_mse", lambda p, t: 1.1 * mse(p, t))
        return
    k2, k4 = nt.fused_mse_loss, nt.fused_mse_loss_weights
    monkeypatch.setattr(nt, "fused_mse_loss", lambda *a: 1.1 * k2(*a))

    def k4_altered(*a):
        loss, w = k4(*a)
        return 1.1 * loss, w
    monkeypatch.setattr(nt, "fused_mse_loss_weights", k4_altered)


def altered_pixel(monkeypatch, cell):
    """One pixel of each frame altered where the kernel produces it."""
    nt = _nt()
    k1 = nt.fused_render_rays

    def render(*a):
        rgb = k1(*a).clone()
        rgb[0] += 0.5
        return rgb
    monkeypatch.setattr(nt, "fused_render_rays", render)


def half_frame(monkeypatch, cell):
    """Half of each frame's rays left unrendered."""
    nt = _nt()
    k1 = nt.fused_render_rays

    def render(packed, o, d, z, r):
        rgb = torch.zeros_like(o)
        h = o.shape[0] // 2
        rgb[:h] = k1(packed, o[:h], d[:h], z[:h], r)
        return rgb
    monkeypatch.setattr(nt, "fused_render_rays", render)


FAULTS = [(c, f) for c in TRAIN_CELLS for f in (unchanged_state, half_batch, altered_loss)]
FAULTS += [("flat-render", altered_pixel), ("flat-render", half_frame)]


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["flat-render"])
def test_sound_run_is_correct(cell):
    res, lines = tiny.run(cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"
    assert lines[-len(res["checks"]):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in res["checks"].items()]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    res, _ = tiny.run(cell)
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", ["flat-train", "hier-train"])
def test_control_is_not_correct(cell):
    """float8 in place of bf16 (the precision below the one the
    configuration states): the reference at float8 against the reference."""
    spec, lp = tiny.loop(cell)
    lp.release()
    numbers = compare.train_numbers(lp.reference_readings("fp8"), lp.reference_readings())
    assert _fails(numbers, spec["limits"]["limits"]), numbers


def test_render_control_is_not_correct():
    spec, lp = tiny.loop("flat-render")
    pairs = [(lp.reference_frame(v, "fp8"), lp.reference_frame(v)) for v in range(3)]
    numbers = compare.frame_numbers(pairs)
    assert _fails(numbers, spec["limits"]["limits"]), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN_CELLS + ["flat-render"])
def test_control_at_the_cells_size(cell):
    """On the card, at the cell's own size, three seeds (three views of the
    render cell): the program within every limit, the control and the
    half-batch fault outside at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the readings at the cell's own size")
    spec = harness.resolve(cell)
    limits, control = spec["limits"]["limits"], spec["limits"]["control"]
    rows = (calibrate.train_readings(spec, [2**31 + 21, 2**31 + 22, 2**31 + 23], "cuda")
            if cell != "flat-render" else
            calibrate.view_readings(spec, 2**31 + 21, "cuda", views=[0, 7, 13]))
    for row in rows:
        assert not _fails(row["program"], limits), row
        assert _fails(row[control], limits), row
        if "half" in row:
            assert _fails(row["half"], limits), row
