"""Incremental SfM: outlier refinement -> two-view init -> PnP registration
-> optional global rotation / translation averaging -> re-triangulation ->
global bundle adjustment.

Host orchestration of the device ops, stage by stage as
sfm_nerf_tpu/sfm/pipeline.py (the reference's Phase1/Wrapper.py:624-889),
with its two documented deviations: incremental triangulation uses the
known global poses of both cameras, and a newly triangulated feature never
overwrites an existing point.

Everything on the device is float64, on the card as on the CPU.  The host
reads one result per stage step (a RANSAC launch, a triangulation, a PnP
solve, a BA round) and keeps the bookkeeping in numpy.  Random draws come
from one ``torch.Generator`` on the device, seeded from ``SfMConfig.seed``:
the F-RANSAC draws pair by pair in sorted pair order, then one PnP draw per
registration attempt; the 5-point RANSAC and the PnP rescue draw from
numpy seed streams, as the JAX pipeline's do.  ``ransac_confidence > 0``
stops each RANSAC on its confidence bound (an adaptive run scores a prefix
of the fixed run's draws).  ``ransac_devices > 1`` runs each pair's F-RANSAC
with its hypotheses sharded over that many devices, ``ba_devices > 1`` the
global BA with its points sharded (parallel/), as the JAX pipeline routes
them.  The figures of the JAX package are not written.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch import DEFAULT_DEVICE
from sfm_nerf_tpu_torch.config import SfMConfig
from sfm_nerf_tpu_torch.io.artifacts import save_ply
from sfm_nerf_tpu_torch.io.sfm_data import (
    load_calibration,
    load_images,
    parse_matching_files,
)
from sfm_nerf_tpu_torch.ops.ba import (
    RC_from_camera_params,
    bundle_adjust,
    camera_params_from_RC,
    fix_gauge_to_first_camera,
    _observe_theta,
    _lanes,
)
from sfm_nerf_tpu_torch.ops.epipolar import (
    RansacResult,
    _host_result,
    cleanup_essential,
    decompose_essential,
    essential_from_fundamental,
    launch_groups,
    ransac_fundamental_bucketed,
    ransac_fundamental_pairs_bucketed,
)
from sfm_nerf_tpu_torch.ops.essential5 import ransac_essential_5pt
from sfm_nerf_tpu_torch.ops.graph import spans
from sfm_nerf_tpu_torch.ops.pnp import (
    nonlinear_pnp_bucketed,
    pnp_ransac_bucketed,
    pnp_ransac_f64_host,
)
from sfm_nerf_tpu_torch.ops.rotation_avg import (
    relative_rotation_residuals,
    rotation_averaging,
)
from sfm_nerf_tpu_torch.ops.translation_avg import (
    direction_residuals_deg,
    pair_direction_world,
    translation_averaging,
)
from sfm_nerf_tpu_torch.ops.triangulation import (
    disambiguate_pose,
    relative_pose_pairs,
    reprojection_errors,
    triangulate_nonlinear,
    triangulate_pair_bucketed,
)
from sfm_nerf_tpu_torch.parallel.ba import bundle_adjust_sharded
from sfm_nerf_tpu_torch.parallel.ransac import ransac_fundamental_sharded
from sfm_nerf_tpu_torch.sfm.tracks import merge_tracks


def shard_devices(device, n: int, flag: str):
    """The ``n`` devices a sharded stage runs on: ``cuda:0`` .. ``cuda:n-1``
    (distinct visible cards) on a card, the CPU ``n`` times on the CPU, as
    the JAX package's virtual CPU devices are."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    avail = torch.cuda.device_count()
    if avail < n:
        raise ValueError(f"{flag} {n} but only {avail} CUDA device(s) visible")
    return [torch.device("cuda", i) for i in range(n)]


def _reproj_err_px(K, R, C, X, uv):
    """Per-point |proj(X) - uv| in px on the host, one camera for every
    point (R (3, 3), C (3,)) or one per point (R (n, 3, 3), C (n, 3));
    points at or behind the camera plane and non-finite projections map
    to +inf."""
    K = np.asarray(K)
    R = np.asarray(R)
    C = np.asarray(C).reshape(R.shape[:-2] + (3,))
    xc = np.einsum("...ij,...j->...i", R, np.asarray(X) - C)
    z = xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * xc[:, 1] / z + K[1, 2]
        e = np.hypot(u - np.asarray(uv)[:, 0], v - np.asarray(uv)[:, 1])
    return np.where((z > 1e-8) & np.isfinite(e), e, np.inf)


def _mean_err_px_np(K, R, C, X, uv, w) -> float:
    """Weighted mean Euclidean pixel error on the host (P = K R [I|-C]),
    for the per-registration prints (PnP.py:132-158)."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    C = np.asarray(C, np.float64).reshape(3)
    P = K @ R @ np.hstack([np.eye(3), -C[:, None]])
    Xh = np.hstack([np.asarray(X, np.float64), np.ones((len(X), 1))])
    x = Xh @ P.T
    proj = x[:, :2] / x[:, 2:3]
    err = np.linalg.norm(proj - np.asarray(uv, np.float64), axis=-1)
    w = np.asarray(w, np.float64)
    return float(np.sum(err * w) / max(np.sum(w), 1.0))


@dataclasses.dataclass
class TwoViewResult:
    C: np.ndarray
    R: np.ndarray
    X: np.ndarray                      # refined 3D points (N, 3)
    X_linear: np.ndarray
    mean_error_linear: float           # mean px error over both frames
    mean_error_nonlinear: float
    per_frame_linear: Tuple[float, float]
    per_frame_nonlinear: Tuple[float, float]


class SfMPipeline:
    """The Phase 1 driver on ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, cfg: SfMConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = torch.device(device)
        # hypothesis-sharded F-RANSAC and point-sharded global BA
        # (parallel/ransac.py, parallel/ba.py) over this many devices
        self.ransac_devices = shard_devices(self.device, cfg.ransac_devices,
                                            "--ransac_devices") \
            if cfg.ransac_devices > 1 else None
        self.ba_devices = shard_devices(self.device, cfg.ba_devices, "--ba_devices") \
            if cfg.ba_devices > 1 else None
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.stats: Dict = {}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    # ------------------------------------------------------------------
    def refine_all_matches(self, matches_dict, all_feature_points, visibility):
        """Per-pair F-RANSAC; drop outlier observations from the tracks and
        the mask (Phase1/Wrapper.py:236-290)."""
        cfg = self.cfg
        refined = {}
        pairs = sorted(matches_dict.items())
        kw = dict(n_iters=cfg.ransac_iters, threshold=cfg.ransac_threshold,
                  normalize=cfg.normalize, scoring=cfg.ransac_scoring,
                  generator=self.generator, device=self.device)
        # adaptive RANSAC: each pair's count scored, in sorted pair order
        adaptive_iters: list = []
        adaptive = dict(confidence=cfg.ransac_confidence, iters_out=adaptive_iters,
                        adaptive_device=cfg.ransac_adaptive_device)
        if self.ransac_devices is not None:
            # per pair, the hypotheses over the devices: the single-device
            # draws whenever the device count divides the chunk count
            del kw["device"]
            results = []
            for _, arr in pairs:
                res = ransac_fundamental_sharded(self._t(arr[:, 0:2]), self._t(arr[:, 2:4]),
                                                 self.ransac_devices, **kw)
                results.append(_host_result(RansacResult(*(t[None] for t in res)),
                                            [len(arr)])[0])
        elif cfg.ransac_batch_pairs:
            results = ransac_fundamental_pairs_bucketed(
                [(arr[:, 0:2], arr[:, 2:4]) for _, arr in pairs], **kw, **adaptive)
        else:
            results = [ransac_fundamental_bucketed(arr[:, 0:2], arr[:, 2:4], **kw,
                                                   **adaptive)
                       for _, arr in pairs]
        if adaptive_iters:
            self.stats["ransac_iters_scored"] = adaptive_iters
        for n, (((i, j), arr), res) in enumerate(zip(pairs, results)):
            inliers = np.asarray(res.inliers)
            used = (f" ({adaptive_iters[n]}/{cfg.ransac_iters} iters)"
                    if adaptive_iters else "")
            print(f"RANSAC: Found {int(res.n_inliers)} inliers out of "
                  f"{len(arr)} matches.{used}")
            refined[(i, j)] = (np.asarray(res.F), arr[inliers])
            for row in arr[~inliers]:
                f_idx = int(row[-1])
                for img in (i, j):
                    if img in all_feature_points[f_idx]:
                        del all_feature_points[f_idx][img]
                        visibility[img][f_idx] = 0
        return refined, all_feature_points, visibility

    # ------------------------------------------------------------------
    def two_view_reconstruct(self, K, F, R1, C1, pts1, pts2) -> TwoViewResult:
        """F -> E -> 4 poses -> batched DLT -> cheirality -> batched LM
        refinement (the reference's ``triangulate``, Wrapper.py:397-594),
        then optionally a two-camera BA with camera 1 fixed."""
        cfg = self.cfg
        Kt = self._t(K)
        R1t, C1t = self._t(R1), self._t(np.asarray(C1).reshape(3))
        p1t, p2t = self._t(pts1), self._t(pts2)
        if cfg.essential_method == "5pt":
            # the minimal solver on the refined matches, on its own seed
            E, _ = ransac_essential_5pt(p1t, p2t, Kt, n_iters=cfg.e5_ransac_iters,
                                        threshold_px=cfg.e5_threshold_px, seed=cfg.seed)
        else:
            E = essential_from_fundamental(Kt, self._t(F))
        if cfg.essential_cleanup:
            E = cleanup_essential(E)
        Cs, Rs = decompose_essential(E, cfg.center_convention)
        X_lin, C2, R2, _, _ = disambiguate_pose(
            Kt, Cs, Rs, p1t, p2t, R1=R1t, T1=-(R1t @ C1t))
        e1_lin = torch.sqrt(reprojection_errors(Kt, R1t, C1t, X_lin, p1t))
        e2_lin = torch.sqrt(reprojection_errors(Kt, R2, C2, X_lin, p2t))
        X_opt, _, _ = triangulate_nonlinear(
            Kt, R1t, C1t, R2, C2, p1t, p2t, X_lin, n_iters=cfg.tri_refine_iters)

        if cfg.two_view_refine_pose:
            # joint pose + points refinement: a two-camera BA with camera 1
            # as the gauge (sfm_nerf_tpu/sfm/pipeline.py:248-303)
            cams2 = camera_params_from_RC(torch.stack([R1t, R2]),
                                          torch.stack([C1t, C2]))
            obs2 = torch.stack([p1t, p2t])
            vis2 = torch.ones(obs2.shape[:2], dtype=Kt.dtype, device=self.device)
            ba2 = bundle_adjust(Kt, cams2, X_opt, obs2, vis2, n_iters=cfg.ba_max_iters)
            cams_fx, pts_fx = fix_gauge_to_first_camera(ba2.camera_params, ba2.points)
            # back from camera 1's frame to the world:
            # X_w = R1ᵀ (X' - t1); R2_w = R2' R1; C2_w = R1ᵀ C2' + C1
            t1 = -(R1t @ C1t)
            Rs_fx, Cs_fx = RC_from_camera_params(cams_fx)
            R2_ba = Rs_fx[1] @ R1t
            C2_ba = R1t.T @ Cs_fx[1] + C1t
            X_ba = (pts_fx - t1) @ R1t
            # a point behind either camera lost that view's residuals in
            # BA (frozen cheirality mask): keep its per-point estimate
            z1b = ((X_opt - C1t) @ R1t.T)[:, 2]
            z2b = ((X_opt - C2) @ R2.T)[:, 2]
            constrained = (z1b > 1e-8) & (z2b > 1e-8)
            X_ba = torch.where(constrained[:, None], X_ba, X_opt)

            def mean_err(Rb, Cb, Xb):
                ea = torch.sqrt(reprojection_errors(Kt, R1t, C1t, Xb, p1t)).mean()
                eb = torch.sqrt(reprojection_errors(Kt, Rb, Cb, Xb, p2t)).mean()
                return (ea + eb) / 2
            # accept the refinement only where it lowers the mean error
            better = mean_err(R2_ba, C2_ba, X_ba) <= mean_err(R2, C2, X_opt)
            R2 = torch.where(better, R2_ba, R2)
            C2 = torch.where(better, C2_ba, C2)
            X_opt = torch.where(better, X_ba, X_opt)

        e1_nl = torch.sqrt(reprojection_errors(Kt, R1t, C1t, X_opt, p1t))
        e2_nl = torch.sqrt(reprojection_errors(Kt, R2, C2, X_opt, p2t))
        n = X_opt.shape[0]
        host = torch.cat([C2, R2.reshape(9), X_opt.reshape(-1), X_lin.reshape(-1),
                          e1_lin, e2_lin, e1_nl, e2_nl]).cpu().numpy()
        X_n = host[12:12 + 3 * n].reshape(n, 3)
        X_lin_n = host[12 + 3 * n:12 + 6 * n].reshape(n, 3)
        e1l, e2l, e1n, e2n = host[12 + 6 * n:].reshape(4, n)
        result = TwoViewResult(
            C=host[:3], R=host[3:12].reshape(3, 3), X=X_n, X_linear=X_lin_n,
            mean_error_linear=float((e1l.mean() + e2l.mean()) / 2),
            mean_error_nonlinear=float((e1n.mean() + e2n.mean()) / 2),
            per_frame_linear=(float(e1l.mean()), float(e2l.mean())),
            per_frame_nonlinear=(float(e1n.mean()), float(e2n.mean())),
        )
        print("number of triangulated points:", len(result.X))
        print("Mean Reprojection error after linear triangulation error: "
              f"{result.mean_error_linear}")
        print("Mean Reprojection error after non linear triangulation error: "
              f"{result.mean_error_nonlinear}")
        return result

    # ------------------------------------------------------------------
    def _select_init_pair(self, refined, K) -> Tuple[int, int]:
        """Initial pair by inlier support x median triangulation parallax
        over the five best-supported pairs (``init_pair='auto'``)."""
        cfg = self.cfg
        Kt = self._t(K)
        cands = sorted(refined.items(), key=lambda kv: -len(kv[1][1]))[:5]
        best, best_score = None, -1.0
        scores: Dict[Tuple[int, int], float] = {}
        for (i, j), (F, m) in cands:
            if len(m) < 8:
                continue
            E = essential_from_fundamental(Kt, self._t(F))
            if cfg.essential_cleanup:
                E = cleanup_essential(E)
            Cs, Rs = decompose_essential(E, cfg.center_convention)
            X, C2, R2, _, _ = disambiguate_pose(
                Kt, Cs, Rs, self._t(m[:, 0:2]), self._t(m[:, 2:4]))
            host = torch.cat([X.reshape(-1), C2, R2.reshape(9)]).cpu().numpy()
            n = len(m)
            X = host[:3 * n].reshape(n, 3)
            C2 = host[3 * n:3 * n + 3]
            R2n = host[3 * n + 3:].reshape(3, 3)
            z1 = X[:, 2]
            z2 = (X - C2) @ R2n[2]
            ok = np.isfinite(X).all(axis=1) & (z1 > 1e-8) & (z2 > 1e-8)
            if int(ok.sum()) < 8:
                scores[(i, j)] = 0.0
                continue
            r1 = X[ok]
            r2 = X[ok] - C2
            cosang = np.sum(r1 * r2, axis=1) / (
                np.linalg.norm(r1, axis=1) * np.linalg.norm(r2, axis=1) + 1e-12)
            med = float(np.median(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))))
            if med < cfg.min_parallax_deg:
                scores[(i, j)] = 0.0
                continue
            score = float(ok.sum()) * min(med, 20.0)
            scores[(i, j)] = score
            if score > best_score:
                best, best_score = (i, j), score
        if best is None:
            best = (1, 2) if (1, 2) in refined else cands[0][0]
        print(f"Initial pair (auto): {best}")
        self.stats["init_pair"] = {
            "pair": list(best),
            "scores": {f"{p[0]}_{p[1]}": s for p, s in scores.items()},
        }
        return best

    # ------------------------------------------------------------------
    def register_camera(self, i, obj_points, img_points, K):
        """PnP RANSAC + nonlinear PnP (the reference's get_pose,
        Wrapper.py:597-620).  Returns (C, R) or (None, None)."""
        cfg = self.cfg
        res = pnp_ransac_bucketed(
            obj_points, img_points, K, n_iters=cfg.pnp_iters,
            threshold=cfg.pnp_threshold, scoring=cfg.ransac_scoring,
            generator=self.generator, device=self.device,
            confidence=cfg.ransac_confidence,
            adaptive_device=cfg.ransac_adaptive_device)
        # 'auto' is off: the port's main path is float64 already
        if int(res.n_inliers) < 6 and cfg.pnp_f64_rescue == "on":
            # re-run this camera's RANSAC on numpy draws of its own seed,
            # every hypothesis LAPACK-grade, before giving up
            n_prior = self.stats.get("pnp_failures", {}).get(i, 0)
            res_r = pnp_ransac_f64_host(
                cfg.seed * 1000003 + i * 31 + n_prior, obj_points, img_points, K,
                n_iters=cfg.pnp_iters, threshold=cfg.pnp_threshold,
                scoring=cfg.ransac_scoring, device=self.device)
            if int(res_r.n_inliers) >= 6:
                print(f"PnP f64 host rescue for image {i}: {int(res_r.n_inliers)} inliers")
                self.stats.setdefault("pnp_rescues", {})[i] = int(res_r.n_inliers)
                res = res_r
        if int(res.n_inliers) < 6:
            print(f"Not enough inliers for reliable PnP with image {i}")
            fails = self.stats.setdefault("pnp_failures", {})
            fails[i] = fails.get(i, 0) + 1
            dump_dir = os.environ.get("SFM_NERF_DUMP_PNP_FAILURES")
            if dump_dir:
                # a debugging aid: the failing inputs, to replay the PnP offline
                os.makedirs(dump_dir, exist_ok=True)
                np.savez(os.path.join(dump_dir, f"fail_cam{i}_try{fails[i]}.npz"),
                         obj=np.asarray(obj_points), img=np.asarray(img_points),
                         K=np.asarray(K), n_inliers=int(res.n_inliers))
            return None, None
        w = np.asarray(res.inliers, np.float64)
        err_lin = _mean_err_px_np(K, res.R, res.C, obj_points, img_points, w)
        C, R, _ = nonlinear_pnp_bucketed(
            K, res.R, res.C, obj_points, img_points, w,
            n_iters=cfg.pnp_refine_iters, device=self.device)
        err_nl = _mean_err_px_np(K, R, C, obj_points, img_points, w)
        print(f"Error after linear PnP: {err_lin}, "
              f"Error after non-linear PnP: {err_nl}")
        self.stats.setdefault("pnp_errors", {})[i] = (err_lin, err_nl)
        return C, R

    # ------------------------------------------------------------------
    def _triangulate_gated(self, K, Ri, Ci, Rj, Cj, p_i, p_j):
        """Triangulate from two posed views; return (X (n, 3), ok (n,)):
        finite, in front of both cameras and, with ``tri_reproj_gate_px``,
        reprojecting within the gate in both source views.  The views are
        shared by every point or given per point (R (n, 3, 3), C (n, 3))."""
        cfg = self.cfg
        Ri, Rj = np.asarray(Ri), np.asarray(Rj)
        Ci = np.asarray(Ci).reshape(Ri.shape[:-2] + (3,))
        Cj = np.asarray(Cj).reshape(Rj.shape[:-2] + (3,))
        _, X = triangulate_pair_bucketed(K, Ri, Ci, Rj, Cj, p_i, p_j,
                                         n_iters=cfg.tri_refine_iters,
                                         device=self.device)
        depth = lambda R, C: np.einsum("...j,...j->...", R[..., 2, :], X - C)
        ok = np.isfinite(X).all(axis=1) & (depth(Ri, Ci) > 1e-8) & (depth(Rj, Cj) > 1e-8)
        if cfg.tri_reproj_gate_px > 0:
            for Rv, Cv, pv in ((Ri, Ci, p_i), (Rj, Cj, p_j)):
                ok &= _reproj_err_px(K, Rv, Cv, X, pv) <= cfg.tri_reproj_gate_px
        return X, ok

    def _triangulate_feature_groups(self, K, camera_info, tracks, groups,
                                    fidx_to_3d, on_new=None) -> int:
        """Triangulate each ``(i, j) -> [feature]`` group from views i and j
        under the current poses, every group in one batch, and write the
        gated results into ``fidx_to_3d``.  Returns the number of newly
        mapped features."""
        rows = [(i, j, f) for (i, j), fs in groups.items() for f in fs]
        if not rows:
            return 0
        cam = lambda c, key: np.asarray(camera_info[c][key], np.float64).reshape(-1)
        Ri = np.stack([cam(i, "R") for i, _, _ in rows]).reshape(-1, 3, 3)
        Rj = np.stack([cam(j, "R") for _, j, _ in rows]).reshape(-1, 3, 3)
        Ci = np.stack([cam(i, "C") for i, _, _ in rows])
        Cj = np.stack([cam(j, "C") for _, j, _ in rows])
        p1 = np.asarray([tracks[f][i][:2] for i, _, f in rows])
        p2 = np.asarray([tracks[f][j][:2] for _, j, f in rows])
        Xn, ok = self._triangulate_gated(K, Ri, Ci, Rj, Cj, p1, p2)
        added = 0
        for (_, _, f), x, good in zip(rows, Xn, ok):
            if good:
                if f not in fidx_to_3d:
                    added += 1
                    if on_new is not None:
                        on_new(f)
                fidx_to_3d[f] = x
        return added

    def _map_unmapped_from_tracks(self, K, camera_info, tracks, fidx_to_3d,
                                  on_new=None) -> int:
        """Triangulate unmapped features from their track observations in
        their first and last registered views (a feature first seen by an
        unregistered image is in no refined pair between registered ones)."""
        reg = sorted(camera_info)
        groups: Dict[Tuple[int, int], list] = {}
        for f, track in enumerate(tracks):
            if f in fidx_to_3d:
                continue
            views = [c for c in reg if c in track]
            if len(views) >= 2:
                groups.setdefault((views[0], views[-1]), []).append(f)
        return self._triangulate_feature_groups(
            K, camera_info, tracks, groups, fidx_to_3d, on_new=on_new)

    # ------------------------------------------------------------------
    def _observation_arrays(self, camera_ids, feat_ids, tracks):
        rowmap = {c: ri for ri, c in enumerate(camera_ids)}
        obs = np.full((len(camera_ids), len(feat_ids), 2), -1.0)
        vis = np.zeros((len(camera_ids), len(feat_ids)))
        for col, f in enumerate(feat_ids):
            for c, uv in tracks[f].items():
                ri = rowmap.get(c)
                if ri is not None:
                    obs[ri, col] = uv[:2]
                    vis[ri, col] = 1.0
        return obs, vis

    def _ba_inputs(self, camera_info, fidx_to_3d, tracks):
        camera_ids = sorted(camera_info)
        feat_ids = [f for f in fidx_to_3d
                    if sum(1 for c in camera_ids if c in tracks[f]) >= 2]
        Rs = np.stack([camera_info[c]["R"] for c in camera_ids])
        Cs = np.stack([np.asarray(camera_info[c]["C"]).reshape(3) for c in camera_ids])
        return camera_ids, feat_ids, Rs, Cs

    def _intermediate_ba(self, K, camera_info, fidx_to_3d, tracks):
        """Light global BA over the registered-so-far reconstruction
        (``ba_interval``): gross outliers gated on the host at the current
        geometry, poses and points written back in place."""
        cfg = self.cfg
        camera_ids, feat_ids, Rs, Cs = self._ba_inputs(camera_info, fidx_to_3d, tracks)
        n_cam, m_pts = len(camera_ids), len(feat_ids)
        if n_cam < 2 or m_pts < 8:
            return
        pts_real = np.stack([fidx_to_3d[f] for f in feat_ids])
        obs, vis = self._observation_arrays(camera_ids, feat_ids, tracks)
        errs = np.stack([_reproj_err_px(K, Rs[ri], Cs[ri], pts_real, obs[ri])
                         for ri in range(n_cam)])
        sel = (vis > 0) & np.isfinite(errs)
        med = float(np.median(errs[sel])) if sel.any() else 0.0
        thresh = max(5.0 * cfg.ba_prune_px, 10.0 * med)
        drop = ~(errs <= thresh) & (vis > 0)
        vis_work = vis * (~drop) if drop.sum() <= 0.5 * vis.sum() else vis

        res = bundle_adjust(
            self._t(K), camera_params_from_RC(self._t(Rs), self._t(Cs)),
            self._t(pts_real), self._t(obs), self._t(vis_work),
            n_iters=cfg.ba_interval_iters, loss=cfg.ba_loss,
            huber_delta=cfg.ba_huber_delta)
        Rs_n, Cs_n = RC_from_camera_params(res.camera_params)
        host = torch.cat([Rs_n.reshape(-1), Cs_n.reshape(-1), res.points.reshape(-1),
                          torch.stack([res.n_residuals.to(torch.float64),
                                       res.initial_cost, res.cost])]).cpu().numpy()
        Rs_n = host[:9 * n_cam].reshape(n_cam, 3, 3)
        Cs_n = host[9 * n_cam:12 * n_cam].reshape(n_cam, 3)
        pts_new = host[12 * n_cam:-3].reshape(m_pts, 3)
        n_obs = max(float(host[-3]), 1.0)
        rb = float(np.sqrt(2 * host[-2] / n_obs))
        ra = float(np.sqrt(2 * host[-1] / n_obs))
        for ri, c in enumerate(camera_ids):
            camera_info[c] = {"R": Rs_n[ri], "C": Cs_n[ri]}
        for col, f in enumerate(feat_ids):
            fidx_to_3d[f] = pts_new[col]
        print(f"  Intermediate BA ({n_cam} cams, {m_pts} pts): "
              f"RMS {rb:.2f} -> {ra:.2f} px over {int(n_obs)} obs")
        self.stats.setdefault("intermediate_ba", []).append({
            "n_cams": n_cam, "n_points": m_pts,
            "rms_px_before": rb, "rms_px_after": ra, "n_obs": int(n_obs),
        })

    # ------------------------------------------------------------------
    def _ba_errs(self, res, obs, Kt):
        """(N, M) per-observation pixel error at the BA optimum, under the
        model BA optimized (the refined intrinsics when they were freed)."""
        if self.cfg.ba_refine_intrinsics:
            proj = _lanes(_observe_theta, res.camera_params, res.points, res.intrinsics)
            return torch.linalg.norm(proj - self._t(obs), dim=-1).cpu().numpy()
        Rs, Cs = RC_from_camera_params(res.camera_params)
        e = reprojection_errors(Kt, Rs, Cs, res.points[None], self._t(obs))
        return torch.sqrt(e).cpu().numpy()

    def _global_ba(self, K, camera_info, fidx_to_3d, tracks):
        """Global BA alternating with outlier pruning (``ba_rounds``),
        after a generous pre-BA gate at the initial geometry."""
        cfg = self.cfg
        camera_ids, feat_ids, Rs, Cs = self._ba_inputs(camera_info, fidx_to_3d, tracks)
        n_cam, m_pts = len(camera_ids), len(feat_ids)
        Kt = self._t(K)
        cams0 = camera_params_from_RC(self._t(Rs), self._t(Cs))
        pts0 = self._t(np.stack([fidx_to_3d[f] for f in feat_ids]))
        obs, vis = self._observation_arrays(camera_ids, feat_ids, tracks)
        vis_work = vis.copy()

        # pre-BA gate: wrong-but-epipolar track observations surface as
        # 100 px-class residuals; drop only gross ones
        Rs_i, Cs_i = RC_from_camera_params(cams0)
        errs0 = torch.sqrt(reprojection_errors(Kt, Rs_i, Cs_i, pts0[None],
                                               self._t(obs))).cpu().numpy()
        med0 = float(np.nanmedian(errs0[vis_work > 0])) if vis_work.any() else 0.0
        if not np.isfinite(med0):
            med0 = 0.0
        pre_thresh = max(5.0 * cfg.ba_prune_px, 10.0 * med0)
        drop0 = ~(errs0 <= pre_thresh) & (vis_work > 0)
        if 0 < drop0.sum() <= 0.5 * vis_work.sum():
            print(f"pre-BA gate: dropping {int(drop0.sum())} / "
                  f"{int(vis_work.sum())} observations above "
                  f"{pre_thresh:.1f} px at the initial geometry")
            vis_work = vis_work * (~drop0)

        obs_t = self._t(obs)
        rms_before = None
        ba_fn = bundle_adjust if self.ba_devices is None else functools.partial(
            bundle_adjust_sharded, devices=self.ba_devices)
        for ba_round in range(max(1, cfg.ba_rounds)):
            res = ba_fn(
                Kt, cams0, pts0, obs_t, self._t(vis_work),
                n_iters=cfg.ba_max_iters, loss=cfg.ba_loss,
                huber_delta=cfg.ba_huber_delta,
                refine_intrinsics=cfg.ba_refine_intrinsics)
            n_obs = max(float(res.n_residuals), 1)
            if rms_before is None:
                rms_before = float(np.sqrt(2 * float(res.initial_cost) / n_obs))
            cams0, pts0 = res.camera_params, res.points
            if ba_round >= cfg.ba_rounds - 1:
                break
            errs = self._ba_errs(res, obs, Kt)
            med = float(np.nanmedian(errs[vis_work > 0]))
            if not np.isfinite(med):
                med = 0.0
            thresh = max(cfg.ba_prune_px, 3.0 * med)
            drop = ~(errs <= thresh) & (vis_work > 0)
            if drop.sum() == 0 or drop.sum() > 0.5 * n_obs:
                break
            print(f"BA round {ba_round + 1}: pruning {int(drop.sum())} / "
                  f"{int(n_obs)} observations above {thresh:.2f} px")
            vis_work = vis_work * (~drop)
        n_obs = max(float(res.n_residuals), 1)
        rms_after = float(np.sqrt(2 * float(res.cost) / n_obs))
        print(f"Bundle adjustment converged. Final cost: {float(res.cost)} "
              f"(RMS {rms_before:.4f} -> {rms_after:.4f} px over {int(n_obs)} obs)")
        self.stats["ba"] = {
            "cost": float(res.cost), "initial_cost": float(res.initial_cost),
            "rms_px_before": rms_before, "rms_px_after": rms_after,
            "n_obs": int(n_obs), "n_cams": n_cam, "n_points": m_pts,
        }
        if cfg.ba_refine_intrinsics:
            th = res.intrinsics.cpu().numpy()
            self.stats["ba"]["intrinsics"] = th.tolist()
            print(f"BA refined intrinsics ({cfg.ba_refine_intrinsics}): "
                  f"fx={th[0]:.2f} fy={th[1]:.2f} cx={th[2]:.2f} cy={th[3]:.2f} "
                  f"k1={th[4]:.5f} k2={th[5]:.5f} (calibration: fx={K[0, 0]:.2f} "
                  f"fy={K[1, 1]:.2f} cx={K[0, 2]:.2f} cy={K[1, 2]:.2f})")

        Rs, Cs = RC_from_camera_params(res.camera_params)
        Rs, Cs = Rs.cpu().numpy(), Cs.cpu().numpy()
        for rowi, c in enumerate(camera_ids):
            camera_info[c] = {"R": Rs[rowi], "C": Cs[rowi]}
        pts_opt = res.points.cpu().numpy()
        for col, f in enumerate(feat_ids):
            fidx_to_3d[f] = pts_opt[col]
        # per-observation error at the optimum (finite only: an
        # unconstrained point's block must not poison the mean)
        errs = self._ba_errs(res, obs, Kt)
        vmask = (vis_work > 0) & np.isfinite(errs)
        if vmask.sum():
            e = errs[vmask]
            self.stats["ba"]["final_err_px"] = {
                "mean": float(e.mean()), "median": float(np.median(e)),
                "p90": float(np.percentile(e, 90)),
            }
            print(f"BA per-observation error: mean {e.mean():.4f} px, "
                  f"median {np.median(e):.4f} px")

    # ------------------------------------------------------------------
    def _relative_poses(self, K, items):
        """(C_rel (M, 3), R_rel (M, 3, 3)) on the device of every pose-graph
        edge ``(pair, F, matches)``, always in the 'hz' centre convention
        (the edge direction needs camera j's true centre in camera i's
        frame): ``global_init_batch_pairs`` pairs a launch
        (``launch_groups``), or one pair a launch when it is 0."""
        cfg = self.cfg
        Kt = self._t(K)
        C_rel = torch.zeros(len(items), 3, dtype=torch.float64, device=self.device)
        R_rel = torch.zeros(len(items), 3, 3, dtype=torch.float64, device=self.device)
        sizes = [len(m) for _, _, m in items]
        groups = (launch_groups(sizes, cfg.global_init_batch_pairs)
                  if cfg.global_init_batch_pairs > 0 else [[g] for g in range(len(items))])
        for group in groups:
            width = max(sizes[g] for g in group)
            p1 = np.zeros((len(group), width, 2))
            p2 = np.zeros((len(group), width, 2))
            for r, g in enumerate(group):
                p1[r, :sizes[g]] = items[g][2][:, 0:2]
                p2[r, :sizes[g]] = items[g][2][:, 2:4]
            C_b, R_b = relative_pose_pairs(
                Kt, self._t(np.stack([items[g][1] for g in group])), self._t(p1),
                self._t(p2), torch.as_tensor([sizes[g] for g in group], device=self.device),
                cleanup=cfg.essential_cleanup, convention="hz")
            gi = torch.as_tensor(group, device=self.device)
            C_rel[gi], R_rel[gi] = C_b, R_b
        return C_rel, R_rel

    def _global_init(self, K, refined, tracks, camera_info, fidx_to_3d):
        """Global re-initialization of the registered cameras
        (sfm_nerf_tpu/sfm/pipeline.py:927-1110): rotation averaging over
        the refined pairs' relative rotations, with ``global_init`` also
        translation averaging of their directions (inlier-weighted, the
        first camera's centre kept, scaled to the incremental baseline of
        the first two cameras), then every mapped point re-triangulated."""
        cfg = self.cfg
        cam_ids = sorted(camera_info)
        col = {c: n for n, c in enumerate(cam_ids)}
        items = [((i, j), F, m) for (i, j), (F, m) in sorted(refined.items())
                 if i in col and j in col and len(m) >= 8]
        pairs = [(col[i], col[j]) for (i, j), _, _ in items]
        C_rel, R_rel = self._relative_poses(K, items) if items else (None, None)
        if not spans(pairs, len(cam_ids)):
            # a disconnected component's eigenvector blocks are independent
            print("Rotation averaging skipped: pose graph disconnected")
            return
        if len(pairs) < len(cam_ids) - 1:
            return
        R_avg = rotation_averaging(pairs, R_rel, len(cam_ids), anchor=0)
        res = torch.rad2deg(relative_rotation_residuals(pairs, R_rel, R_avg))
        # the anchor keeps its global rotation: the averaged ones are
        # relative to it
        R_anchor = self._t(camera_info[cam_ids[0]]["R"])
        R_new = (R_avg @ R_anchor).cpu().numpy()
        mean_res = float(res.mean())
        print(f"Rotation averaging over {len(pairs)} pairs: "
              f"mean pairwise residual {mean_res:.2f} deg")
        for n, c in enumerate(cam_ids):
            camera_info[c]["R"] = R_new[n]
        self.stats["rotation_avg"] = {"n_pairs": len(pairs), "mean_residual_deg": mean_res}
        if cfg.global_init:
            first = torch.as_tensor([a for a, _ in pairs], device=self.device)
            u_world = pair_direction_world(self._t(R_new)[first], C_rel)
            C_glob = translation_averaging(
                pairs, u_world, len(cam_ids), anchor=0,
                weights=self._t([len(m) for _, _, m in items]))
            # gauge: the anchor keeps its centre; the scale is the
            # incremental solution's baseline of the first two cameras
            C_glob = C_glob - C_glob[0]
            ref_base = np.linalg.norm(np.asarray(camera_info[cam_ids[1]]["C"]).reshape(3)
                                      - np.asarray(camera_info[cam_ids[0]]["C"]).reshape(3))
            new_base = float(torch.linalg.norm(C_glob[1] - C_glob[0]))
            if new_base > 1e-12 and ref_base > 1e-12:
                C_glob = C_glob * (ref_base / new_base)
            C0 = np.asarray(camera_info[cam_ids[0]]["C"]).reshape(3)
            med = float(np.median(direction_residuals_deg(pairs, u_world, C_glob).cpu().numpy()))
            print(f"Translation averaging over {len(pairs)} pairs: "
                  f"median direction residual {med:.2f} deg")
            C_new = C_glob.cpu().numpy()
            for n, c in enumerate(cam_ids):
                camera_info[c]["C"] = C_new[n] + C0
            self.stats["translation_avg"] = {"n_pairs": len(pairs),
                                             "median_residual_deg": med}
        # the points were triangulated under the old poses
        self._retriangulate_all(K, camera_info, tracks, fidx_to_3d, cam_ids)

    def _retriangulate_all(self, K, camera_info, tracks, fidx_to_3d, cam_ids):
        """Re-triangulate every mapped feature from its first and last
        registered views under the current poses, in place (gated as
        ``_triangulate_feature_groups``)."""
        groups: Dict[Tuple[int, int], list] = {}
        for f in list(fidx_to_3d):
            views = [c for c in cam_ids if c in tracks[f]]
            if len(views) >= 2:
                groups.setdefault((views[0], views[-1]), []).append(f)
        self._triangulate_feature_groups(K, camera_info, tracks, groups, fidx_to_3d)

    # ------------------------------------------------------------------
    def _register_all(self, K, refined, tracks, camera_info, fidx_to_3d):
        """Incremental registration: PnP for each unregistered image in
        index (or greedy) order, new points against every registered
        camera, retry passes, interval BAs."""
        cfg = self.cfg
        support: Dict[int, int] = {
            i: 0 for i in range(1, cfg.num_images + 1) if i not in camera_info}

        def count_support(f_idx):
            for img in tracks[f_idx]:
                if img in support:
                    support[img] += 1

        for f_idx in fidx_to_3d:
            count_support(f_idx)

        since_ba = 0
        failed: list = []
        retries_left = cfg.registration_retries
        progressed = True
        while True:
            if not support:
                if not (failed and retries_left > 0 and progressed):
                    break
                if cfg.ba_interval > 0 and since_ba > 0:
                    self._intermediate_ba(K, camera_info, fidx_to_3d, tracks)
                    since_ba = 0
                print(f"  Retry pass {cfg.registration_retries - retries_left + 1}: "
                      f"re-attempting {len(failed)} skipped images.")
                for r in failed:
                    support[r] = sum(1 for f_idx in fidx_to_3d if r in tracks[f_idx])
                failed = []
                retries_left -= 1
                progressed = False
            if cfg.view_order == "greedy":
                i = max(support, key=support.get)
                if support[i] < 8:
                    added = self._map_unmapped_from_tracks(
                        K, camera_info, tracks, fidx_to_3d, on_new=count_support)
                    if added:
                        print(f"  Track-completion pass mapped {added} points; "
                              "retrying registration.")
                        continue
                    print(f"  Best remaining view {i} has only {support[i]} "
                          "2D-3D correspondences; stopping registration.")
                    break
            else:
                i = min(support)
            del support[i]
            print(f"Registering Image: {i} ......")
            obj_points, img_points = [], []
            for f_idx, xyz in fidx_to_3d.items():
                if i in tracks[f_idx]:
                    obj_points.append(xyz)
                    img_points.append(tracks[f_idx][i][:2])
            if len(obj_points) < 8:
                print(f"  Not enough 2D-3D correspondences to solve PnP for "
                      f"image {i}. Skipping.")
                failed.append(i)
                continue
            C, R = self.register_camera(i, np.asarray(obj_points),
                                        np.asarray(img_points), K)
            if C is None:
                print(f"  Could not estimate camera pose for image {i}. Skipping.")
                failed.append(i)
                continue
            camera_info[i] = {"R": R, "C": C}

            # new points against every other registered camera
            for j in sorted(camera_info):
                if j == i:
                    continue
                pair = (j, i) if j < i else (i, j)
                if pair not in refined:
                    print(f"No matches for pair {pair}. Skipping.")
                    continue
                new_rows = [row for row in refined[pair][1]
                            if int(row[-1]) not in fidx_to_3d]
                if not new_rows:
                    continue
                arr = np.asarray(new_rows)
                # matching rows hold (lower image cols 0:2, higher 2:4)
                p_j, p_i = ((arr[:, 0:2], arr[:, 2:4]) if j < i
                            else (arr[:, 2:4], arr[:, 0:2]))
                Xnew, ok_new = self._triangulate_gated(
                    K, camera_info[j]["R"], camera_info[j]["C"], R, C, p_j, p_i)
                for n, row in enumerate(arr):
                    f_new = int(row[-1])
                    if ok_new[n] and f_new not in fidx_to_3d:
                        fidx_to_3d[f_new] = Xnew[n]
                        count_support(f_new)
            print(f"Registered Camera: {i}")
            progressed = True
            since_ba += 1
            if cfg.ba_interval > 0 and since_ba >= cfg.ba_interval:
                self._intermediate_ba(K, camera_info, fidx_to_3d, tracks)
                since_ba = 0

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        cfg = self.cfg
        t_start = time.time()
        stage_log: list = []

        def stage(name):
            prev = stage_log[-1][1] if stage_log else 0.0
            now = time.time() - t_start
            stage_log.append((name, now, now - prev))

        images = load_images(cfg.data_path, cfg.num_images)
        K = load_calibration(f"{cfg.data_path}/calibration.txt")
        print("Camera intrinsic matrix K:")
        print(K)
        matches_dict, tracks, visibility = parse_matching_files(
            cfg.data_path, cfg.num_images)
        stage("load+parse")
        refined, tracks, visibility = self.refine_all_matches(
            matches_dict, tracks, visibility)
        stage("ransac_refine")
        if cfg.merge_tracks:
            # after RANSAC: unions of verified observations only
            n_before = len(tracks)
            remapped, tracks, visibility, _ = merge_tracks(
                {pair: m for pair, (_, m) in refined.items()}, tracks,
                tol=cfg.merge_tol)
            refined = {pair: (F, remapped[pair]) for pair, (F, _) in refined.items()}
            print(f"Track merging: {n_before} -> {len(tracks)} tracks")
            self.stats["track_merge"] = {"before": n_before, "after": len(tracks)}

        # --- two-view initialization -----------------------------------
        init_pair = self._select_init_pair(refined, K) if cfg.init_pair == "auto" \
            else (1, 2)
        a, b = init_pair
        F12, m12 = refined[init_pair]
        camera_info = {a: {"R": np.eye(3), "C": np.zeros(3)}}
        tv = self.two_view_reconstruct(K, F12, camera_info[a]["R"], camera_info[a]["C"],
                                       m12[:, 0:2], m12[:, 2:4])
        camera_info[b] = {"R": tv.R, "C": tv.C}
        self.stats["two_view"] = {
            "linear": tv.per_frame_linear, "nonlinear": tv.per_frame_nonlinear,
            "mean_linear": tv.mean_error_linear,
            "mean_nonlinear": tv.mean_error_nonlinear,
        }
        fidx_to_3d: Dict[int, np.ndarray] = {
            int(row[-1]): tv.X[n] for n, row in enumerate(m12)}
        stage("two_view_init")

        self._register_all(K, refined, tracks, camera_info, fidx_to_3d)
        stage("registration")
        if (cfg.global_rotation_init or cfg.global_init) and len(camera_info) >= 3:
            self._global_init(K, refined, tracks, camera_info, fidx_to_3d)
        stage("global_init")

        print("Bundle adjustment...")
        self._global_ba(K, camera_info, fidx_to_3d, tracks)

        # coloured cloud: each feature's pixel in its first decoded view
        # (the images are RGB, so no channel swap)
        colors = []
        for f in fidx_to_3d:
            c = (180, 180, 180)
            for img_id, (u, v) in sorted(tracks[f].items()):
                if 1 <= img_id <= len(images) and images[img_id - 1] is not None:
                    img = images[img_id - 1]
                    ui = int(np.clip(round(u), 0, img.shape[1] - 1))
                    vi = int(np.clip(round(v), 0, img.shape[0] - 1))
                    r, g, bl = img[vi, ui][:3]
                    c = (int(r), int(g), int(bl))
                    break
            colors.append(c)
        all_points = np.asarray(list(fidx_to_3d.values()))
        save_ply(all_points, np.asarray(colors, np.uint8), cfg.output_dir)
        stage("ba+artifacts")

        self.stats["elapsed_s"] = time.time() - t_start
        self.stats["n_points_total"] = len(fidx_to_3d)
        self.stats["n_registered"] = len(camera_info)
        self.stats["device"] = str(self.device)
        self.stats["stage_seconds"] = {n: round(d, 2) for n, _, d in stage_log}
        print("stage timing: " + " | ".join(f"{n} {d:.1f}s" for n, _, d in stage_log))
        with open(os.path.join(cfg.output_dir, "sfm_stats.json"), "w") as f:
            json.dump(self.stats, f, indent=1, default=float)
        print("Done")
        return {"camera_info": camera_info, "points": fidx_to_3d,
                "stats": self.stats}
