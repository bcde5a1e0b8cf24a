"""The port's figures (io/figure.py, io/jpeg.py, io/artifacts.py, test mode's
figure_{i}.png, Wrapper's --plot_rays) against the JAX package's, which
matplotlib and cv2 draw, on identical seeded inputs.

The port rasterises with numpy alone, so its figures are held to the same
geometry, not the same pixels:

- every writer: the same file name and pixel shape;
- 2-D plots: the axes frame within 3 px of the one found in JAX's PNG, the
  ink centroid of each series and camera marker (located by its colour and
  its tints over white) within 1 % of the width;
- 3-D plots: each camera marker's centroid within 1.5 % of the width, each
  point series' ink bounding box (blue, and red where it is drawn) within 2 %;
- overlays: the array before encoding equal, bit for bit, to what
  cv2.circle draws in the JAX writer's order; the two JPEGs, each decoded by
  cv2, at >= 35 dB of each other;
- write_jpeg: a baseline (SOF0) file that cv2 decodes to >= 40 dB of its
  source at quality 95;
- the match figure: shape (max h, w1 + w2), each half equal to its input
  away from the drawn circles and lines, ink on both circles of every match;
- figure_{i}.png and ray_plot_{count}.png against figures built with the
  JAX code's own matplotlib calls: the same shape, each panel's box within
  2 % of the width and its content at >= 30 dB, the ray fan's ink bounding
  box within 2 % of the width, each tab10 colour's ink centroid within 1 %
  of the width and its ink within 5 % of JAX's.

Skipped where matplotlib or cv2 is missing (the card's machine has neither).
"""

import os

import numpy as np
import pytest
import torch

plt_mod = pytest.importorskip("matplotlib")
cv2 = pytest.importorskip("cv2")

from sfm_nerf_tpu.io import artifacts as jart  # noqa: E402
from sfm_nerf_tpu_torch.io import artifacts as tart  # noqa: E402
from sfm_nerf_tpu_torch.io.jpeg import sof0_size, write_jpeg  # noqa: E402
from sfm_nerf_tpu_torch.io.png import read_png  # noqa: E402

TAB10 = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
NAMED = {"blue": "#0000ff", "green": "#008000", "red": "#ff0000",
         "orange": "#ffa500", "purple": "#800080"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _rgb(c):
    c = TAB10[int(c[1:])] if c.startswith("C") else NAMED[c]
    return np.array([int(c[i:i + 2], 16) for i in (1, 3, 5)], float)


def _read(path):
    """Decoded RGB of a PNG or JPEG file (cv2 reads BGR)."""
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert img is not None, path
    return img[..., ::-1].astype(np.float32)


def _tint_mask(img, colour, t_min=0.3, tol=30.0):
    """Pixels within ``tol`` of a tint of ``colour`` over white, at least
    ``t_min`` of the way from white (a marker at alpha t, or an edge)."""
    d = (_rgb(colour) - 255.0).astype(np.float32)
    diff = img - np.float32(255.0)
    t = np.clip(diff @ (d / (d @ d)), t_min, 1.0)
    r = diff - t[..., None] * d
    return np.einsum("...c,...c->...", r, r) < tol * tol


def _centroid(mask, step=1):
    """Centroid of a mask found on every ``step``-th pixel, in pixels."""
    ys, xs = np.nonzero(mask)
    assert len(xs), "colour not found"
    return np.array([xs.mean(), ys.mean()]) * step


def _bbox(mask, step=1):
    ys, xs = np.nonzero(mask)
    assert len(xs), "ink not found"
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], float) * step


def _axes_frame(img):
    """The 2-D axes frame: the rows and columns that are mostly dark."""
    dark = img.max(-1) < 60
    rows = np.flatnonzero(dark.mean(1) > 0.5)
    cols = np.flatnonzero(dark.mean(0) > 0.5)
    return np.array([cols.min(), rows.min(), cols.max(), rows.max()])


def _psnr(a, b):
    d = np.asarray(a, float) - np.asarray(b, float)
    return 10 * np.log10(255.0 ** 2 / max((d * d).mean(), 1e-12))


# ---------------------------------------------------------------------------
# seeded inputs shaped like a two-view initialisation and a small ring
# ---------------------------------------------------------------------------

def _two_view(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(300, 3)) * [2.0, 1.0, 1.5] + [0.0, 0.0, 8.0]
    X_opt = X + rng.normal(size=X.shape) * 0.05
    C = np.array([1.0, 0.05, 0.2])
    cands = [X, X * [-1, 1, -1], X * [1, -1, 1] + [0.5, 0, 0], X * [-1, -1, -1]]
    return cands, X, X_opt, C


def _ring(seed=0, n_cams=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 3)) * [2.5, 1.0, 2.5] + [0.0, 0.0, 6.0]
    th = np.linspace(0, 0.6 * np.pi, n_cams)
    cams = {i + 1: {"R": np.eye(3), "C": np.array([4 * np.sin(a), 0.1 * i, 6 - 4 * np.cos(a)])}
            for i, a in enumerate(th)}
    return X, cams


def _write_both(tmp_path, fn, *args):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    jp = getattr(jart, fn)(*args, out_dir=str(jdir))
    tp = getattr(tart, fn)(*args, out_dir=str(tdir))
    jp = [jp] if isinstance(jp, str) else list(jp)
    tp = [tp] if isinstance(tp, str) else list(tp)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    out = []
    for a, b in zip(jp, tp):
        ja, ta = _read(a), _read(b)
        assert ta.shape == ja.shape, (os.path.basename(a), ta.shape, ja.shape)
        out.append((ja, ta))
    return out


# ---------------------------------------------------------------------------
# the 2-D plots
# ---------------------------------------------------------------------------

def test_x_vs_z_plot(tmp_path):
    cands, *_ = _two_view()
    [(ja, ta)] = _write_both(tmp_path, "save_x_vs_z_plot", cands)
    assert ta.shape == (2400, 3000, 3)
    np.testing.assert_allclose(_axes_frame(ta), _axes_frame(ja), atol=3)
    w = ta.shape[1]
    # colours are located on every other pixel: 1 % of the width is 30 px
    ja, ta = ja[::2, ::2], ta[::2, ::2]
    for colour in ("blue", "green", "red", "orange"):
        d = np.linalg.norm(_centroid(_tint_mask(ta, colour), 2)
                           - _centroid(_tint_mask(ja, colour), 2))
        assert d <= 0.01 * w, (colour, d)


def test_topdown_plot(tmp_path):
    X, cams = _ring()
    [(ja, ta)] = _write_both(tmp_path, "save_topdown_plot", X, cams)
    assert ta.shape == (1000, 1000, 3)
    np.testing.assert_allclose(_axes_frame(ta), _axes_frame(ja), atol=3)
    w = ta.shape[1]
    # the cameras take the line colour cycle C0, C1, ... in insertion order
    for k, colour in enumerate(["blue"] + [f"C{i}" for i in range(len(cams))]):
        mj = _tint_mask(ja, colour, t_min=0.8 if k else 0.3, tol=20)
        mt = _tint_mask(ta, colour, t_min=0.8 if k else 0.3, tol=20)
        d = np.linalg.norm(_centroid(mt) - _centroid(mj))
        assert d <= 0.01 * w, (colour, d)


# ---------------------------------------------------------------------------
# the 3-D plots
# ---------------------------------------------------------------------------

def _check_3d(ja, ta, cameras, clouds):
    w = ta.shape[1]
    # colours are located on every other pixel: the limits are 45 and 60 px
    ja, ta = ja[::2, ::2], ta[::2, ::2]
    for colour in cameras:
        mj = _tint_mask(ja, colour, t_min=0.9, tol=12)
        mt = _tint_mask(ta, colour, t_min=0.9, tol=12)
        d = np.linalg.norm(_centroid(mt, 2) - _centroid(mj, 2))
        assert d <= 0.015 * w, (colour, d)
    # each point series' ink bounding box (its tints over white)
    for colour in clouds:
        bj = _bbox(_tint_mask(ja, colour, tol=20), 2)
        bt = _bbox(_tint_mask(ta, colour, tol=20), 2)
        assert np.abs(bt - bj).max() <= 0.02 * w, (colour, bt, bj)


def test_3d_points_plot(tmp_path):
    _, X, X_opt, C = _two_view()
    [(ja, ta)] = _write_both(tmp_path, "save_3d_points_plot", X, C, X_opt)
    assert ta.shape == (2400, 3000, 3)
    # blue: 'Linear Triangulation', red: 'Non-Linear Optimization'
    _check_3d(ja, ta, ["green", "purple"], ["blue", "red"])


def test_reconstruction_plot(tmp_path):
    X, cams = _ring()
    [(ja, ta)] = _write_both(tmp_path, "save_reconstruction_plot", X, cams)
    assert ta.shape == (2400, 3000, 3)
    _check_3d(ja, ta, [f"C{i}" for i in cams], ["blue"])


@pytest.mark.parametrize("writer,args,name,shape", [
    ("save_x_vs_z_plot", ([np.zeros((0, 3))] * 4,), "x_vs_z_triangulation.png", (2400, 3000)),
    ("save_3d_points_plot", (np.zeros((0, 3)), np.ones(3)), "3d_points_visualization.png",
     (2400, 3000)),
    ("save_reconstruction_plot", (np.zeros((0, 3)), {1: {"C": np.zeros(3)}, 2: {"C": np.ones(3)}}),
     "complete_reconstruction.png", (2400, 3000)),
    ("save_topdown_plot", (np.zeros((0, 3)), {1: {"C": np.zeros(3)}}), "topdown_view.png",
     (1000, 1000)),
])
def test_plots_of_empty_clouds_are_written(tmp_path, writer, args, name, shape):
    """A degenerate init pair can leave no points: every plot is still
    written, at its size (the JAX writers guard the same case)."""
    path = getattr(tart, writer)(*args, out_dir=str(tmp_path))
    assert os.path.basename(path) == name
    assert read_png(path).shape == (*shape, 3)


# ---------------------------------------------------------------------------
# overlays and the JPEG writer
# ---------------------------------------------------------------------------

def _textured(h=600, w=800, seed=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    img = np.stack([128 + 100 * np.sin(xx / 23 + yy / 41), 128 + 90 * np.cos(yy / 17),
                    (xx + yy) / (h + w) * 255], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_overlay_rgb(img_rgb, proj, orig):
    """artifacts.py:197-204 of the JAX package on the BGR copy of the frame."""
    out = img_rgb[..., ::-1].copy()
    for pt in np.asarray(proj):
        if np.all(np.isfinite(pt)):
            cv2.circle(out, (int(round(pt[0])), int(round(pt[1]))), 2, (0, 255, 0), -1)
    for pt in np.asarray(orig):
        cv2.circle(out, (int(round(pt[0])), int(round(pt[1]))), 2, (0, 0, 255), -1)
    return out[..., ::-1]


def _overlay_inputs(seed=0, n=300):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3, -3], [803, 603], (n, 2))
    proj = pts + rng.normal(0, 1.5, (n, 2))
    proj[::7] += 0.5 - (proj[::7] % 1)            # exact .5: round half to even
    proj[5] = np.nan
    proj[11, 0] = np.inf
    return proj, pts


def test_overlay_array_is_cv2_circle_bit_for_bit():
    img = _textured()
    proj, pts = _overlay_inputs()
    np.testing.assert_array_equal(tart.draw_overlay(img, proj, pts),
                                  _cv2_overlay_rgb(img, proj, pts))


@pytest.mark.parametrize("stage", ["lineartriangulation", "nonlineartriangulation"])
def test_projection_overlays(tmp_path, stage):
    img1, img2 = _textured(seed=0), _textured(seed=1)[:, ::-1].copy()
    (p1, o1), (p2, o2) = _overlay_inputs(0), _overlay_inputs(1)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    # the JAX package's frames are cv2's BGR, the port's RGB
    jp = jart.save_projection_overlays(img1[..., ::-1].copy(), img2[..., ::-1].copy(),
                                       p1, p2, o1, o2, stage, str(jdir))
    tp = tart.save_projection_overlays(img1, img2, p1, p2, o1, o2, stage, str(tdir))
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    if stage == "nonlineartriangulation":
        assert os.path.basename(tp[1]) == "Frame2 -non lineartriangulation.jpg"
    for a, b in zip(jp, tp):
        ja, ta = _read(a), _read(b)
        assert ta.shape == ja.shape == (600, 800, 3)
        assert sof0_size(b) == (800, 600)
        assert _psnr(ta, ja) >= 35.0, (b, _psnr(ta, ja))


def test_write_jpeg_is_baseline_and_cv2_reads_it(tmp_path):
    img = _textured()
    path = str(tmp_path / "t.jpg")
    write_jpeg(path, img)
    data = open(path, "rb").read()
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert b"\xff\xc0" in data and b"\xff\xc2" not in data       # baseline, not progressive
    assert sof0_size(path) == (800, 600)
    assert _psnr(_read(path), img.astype(float)) >= 40.0
    # an odd size pads to whole MCUs and still decodes to its own size
    odd = img[:37, :53].copy()
    write_jpeg(path, odd)
    assert _read(path).shape == (37, 53, 3) and _psnr(_read(path), odd.astype(float)) >= 35.0


# ---------------------------------------------------------------------------
# the feature-match figure
# ---------------------------------------------------------------------------

def _segment_distance(px, a, b):
    d = b - a
    t = np.clip(((px[:, None] - a[None]) * d[None]).sum(-1) / np.maximum((d * d).sum(-1), 1e-12),
                0, 1)
    return np.linalg.norm(px[:, None] - (a[None] + t[..., None] * d[None]), axis=-1).min(1)


def test_match_visualization(tmp_path):
    rng = np.random.default_rng(0)
    img1 = _textured(120, 160, 0)
    img2 = _textured(100, 140, 1)
    n = 30
    m = np.column_stack([rng.uniform(5, 155, n), rng.uniform(5, 115, n),
                         rng.uniform(5, 135, n), rng.uniform(5, 95, n), np.arange(n)])
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jp = jart.save_match_visualization(img1[..., ::-1].copy(), img2[..., ::-1].copy(), m,
                                       str(jdir), name="feature_matches_1_2.png")
    tp = tart.save_match_visualization(img1, img2, m, str(tdir), name="feature_matches_1_2.png")
    assert os.path.basename(tp) == os.path.basename(jp)
    got = read_png(tp)
    assert got.shape == _read(jp).shape == (120, 300, 3)
    base = np.zeros_like(got)
    base[:120, :160] = img1
    base[:100, 160:] = img2
    ys, xs = np.nonzero((got != base).any(-1))
    px = np.column_stack([xs, ys]).astype(float)
    a, b = m[:, 0:2], m[:, 2:4] + [160, 0]
    near = np.minimum(_segment_distance(px, a, b),
                      np.minimum(np.abs(np.linalg.norm(px[:, None] - a[None], axis=-1) - 3).min(1),
                                 np.abs(np.linalg.norm(px[:, None] - b[None], axis=-1) - 3).min(1)))
    assert len(px) > 0 and near.max() <= 2.5, near.max()
    # every match is drawn: ink on the radius-3 circle (within 1 px) around
    # each of its two keypoints
    for kp in (a, b):
        ring = np.abs(np.linalg.norm(px[:, None] - kp[None], axis=-1) - 3) <= 1
        assert ring.any(0).all(), np.flatnonzero(~ring.any(0))


# ---------------------------------------------------------------------------
# figure_{i}.png of test mode and --plot_rays
# ---------------------------------------------------------------------------

def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _panels(img):
    """The two image panels of a figure_{i}.png: the boxes of mostly
    non-white rows and columns of each half."""
    out = []
    half = img.shape[1] // 2
    for part, x_off in ((img[:, :half], 0), (img[:, half:], half)):
        ink = np.abs(part - 255).max(-1) > 12
        rows = np.flatnonzero(ink.mean(1) > 0.5)
        cols = np.flatnonzero(ink.mean(0) > 0.5)
        out.append(np.array([cols.min() + x_off, rows.min(), cols.max() + x_off, rows.max()]))
    return out


@pytest.mark.parametrize("n", [120, 400])
def test_test_mode_figure(tmp_path, n):
    from sfm_nerf_tpu_torch.cli.nerf import save_test_figure

    yy, xx = np.mgrid[0:n, 0:n] / n
    rng = np.random.default_rng(0)
    gt8 = (np.stack([0.1 + 0.8 * xx, 0.1 + 0.8 * yy, 0.5 + 0.3 * np.sin(9 * xx + 7 * yy)], -1)
           * 255).astype(np.uint8)
    pred8 = np.clip(gt8 + rng.normal(0, 6, gt8.shape), 0, 255).astype(np.uint8)
    mse_val = float(((pred8 / 255.0 - gt8 / 255.0) ** 2).mean())
    # Phase2/train.py:269-279
    plt = _mpl()
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    axes[0].imshow(gt8)
    axes[0].set_title("Ground Truth")
    axes[0].axis("off")
    axes[1].imshow(pred8)
    axes[1].set_title(f"Prediction (Loss: {mse_val:.6f})")
    axes[1].axis("off")
    fig.tight_layout()
    fig.savefig(str(tmp_path / "ref.png"), dpi=150)
    plt.close(fig)
    save_test_figure(str(tmp_path / "figure_0.png"), gt8, pred8, mse_val)
    ref, got = _read(tmp_path / "ref.png"), _read(tmp_path / "figure_0.png")
    assert got.shape == ref.shape == (900, 1800, 3)
    for br, bg in zip(_panels(ref), _panels(got)):
        assert np.abs(br - bg).max() <= 0.02 * 1800, (br, bg)
        x0, y0 = np.maximum(br[:2], bg[:2]) + 2
        x1, y1 = np.minimum(br[2:], bg[2:]) - 2
        p = _psnr(got[y0:y1, x0:x1], ref[y0:y1, x0:x1])
        assert p >= 30.0, p


@pytest.fixture(scope="module")
def ray_setup(tmp_path_factory):
    import jax

    from sfm_nerf_tpu.config import NeRFModelConfig
    from sfm_nerf_tpu.models import init_nerf_params
    from sfm_nerf_tpu.train.checkpoint import save_checkpoint
    from util_synthetic import make_blender_dataset

    root = tmp_path_factory.mktemp("rays")
    data = make_blender_dataset(str(root / "data" / "scene"), n_frames=2, height=100, width=100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        init_nerf_params(jax.random.key(0), NeRFModelConfig(hidden=32, n_pos_freq=4,
                                                            n_dir_freq=2)))
    save_checkpoint(str(root / "ckpt" / "scene"), 1, params, final=True)
    return root, data + "/"


def test_plot_rays(ray_setup):
    import jax.numpy as jnp

    from sfm_nerf_tpu.io.blender import pose_spherical
    from sfm_nerf_tpu.ops.rays import image_rays
    from sfm_nerf_tpu_torch.cli import wrapper
    from sfm_nerf_tpu_torch.io.blender import load_camera_info

    root, data = ray_setup
    out = root / "gif"
    records = wrapper.main(["--mode", "gif", "--plot_rays", "--n_frames", "1", "--device", "cpu",
                            "--data_path", data, "--checkpoint_path", str(root / "ckpt"),
                            "--images_path", str(out), "--no_perturb", "--n_sample", "16"])
    assert len(records) == 1 and (out / "image_1.png").exists()
    cam = load_camera_info(data, "train")
    K = jnp.asarray(cam.camera_matrix)
    c2w = jnp.asarray(pose_spherical(0.0, -30.0, 4.0))
    # Phase2/Wrapper.py:251-264
    plt = _mpl()
    o, d = image_rays(K, c2w, cam.height, cam.width)
    o = np.asarray(o)[::50]
    p2 = o + 6.0 * np.asarray(d)[::50]
    fig = plt.figure(figsize=(12, 12))
    ax = plt.axes(projection="3d")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    for p1, p2i in zip(o, p2):
        ax.plot([p1[0], p2i[0]], [p1[1], p2i[1]], [p1[2], p2i[2]])
    fig.savefig(str(root / "ref.png"))
    plt.close(fig)
    ref, got = _read(root / "ref.png"), _read(out / "ray_plot_1.png")
    assert got.shape == ref.shape == (1200, 1200, 3)
    # the fan: the saturated pixels (panes, grid and text are grey)
    fan_r, fan_g = _bbox(ref.std(-1) > 30), _bbox(got.std(-1) > 30)
    assert np.abs(fan_g - fan_r).max() <= 0.02 * 1200, (fan_g, fan_r)
    # the segments cycle through tab10 (200 rays, 20 a colour): each colour's
    # ink centroid within 1 % of the width, its ink within 5 % of JAX's (one
    # segment of 20 is ~5 %)
    for colour in [f"C{i}" for i in range(10)]:
        mr = _tint_mask(ref, colour, t_min=0.6, tol=25)
        mg = _tint_mask(got, colour, t_min=0.6, tol=25)
        d = np.linalg.norm(_centroid(mg) - _centroid(mr))
        assert d <= 0.01 * 1200, (colour, d)
        assert abs(int(mg.sum()) - int(mr.sum())) <= 0.05 * mr.sum(), (colour, mg.sum(), mr.sum())


def test_no_plot_rays_writes_no_ray_plot(ray_setup):
    from sfm_nerf_tpu_torch.cli import nerf

    root, data = ray_setup
    out = root / "gif_plain"
    nerf.main(["--mode", "gif", "--n_frames", "1", "--device", "cpu", "--data_path", data,
               "--checkpoint_path", str(root / "ckpt"), "--images_path", str(out),
               "--no_perturb", "--n_sample", "16"])
    assert sorted(os.listdir(out)) == ["image_1.png"]


def test_a_figure_that_cannot_be_written_raises(tmp_path):
    """No fallback: a writer whose directory is missing fails."""
    X, cams = _ring()
    with pytest.raises(OSError):
        tart.save_topdown_plot(X, cams, out_dir=str(tmp_path / "missing"))
    proj, pts = _overlay_inputs()
    with pytest.raises(OSError):
        tart.save_projection_overlays(_textured(), _textured(), proj, proj, pts, pts,
                                      "lineartriangulation", out_dir=str(tmp_path / "missing"))
