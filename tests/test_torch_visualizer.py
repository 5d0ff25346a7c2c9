"""The port's visualizer (``utils/visualizer.py``, Pillow) against the JAX
one (``monoflex_tpu/utils/visualizer.py``, matplotlib): the same geometry
(ground-truth corners, projected wireframes, bird's-eye footprints,
keypoints), read from the JAX drawing functions through a recording axis;
the PNGs written; and ``inference(visualize=True)`` writing at most 8 of
them under ``<output>/vis``.

Tolerance: 1e-9 abs on corners and projections (the same float64 numpy on
both sides, one ``box3d_corners`` and one projection each).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from monoflex_tpu.core.geometry import Calibration as JaxCalibration
from monoflex_tpu.utils import visualizer as jax_vis
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.core.geometry_np import Calibration
from monoflex_tpu_torch.data.dataset import KITTIDataset
from monoflex_tpu_torch.data.synthetic import make_synthetic_kitti
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.engine.inference import inference
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.train.train_step import make_eval_step
from monoflex_tpu_torch.utils import visualizer as vis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2], [0, 0, 1.0, 0.003]])
ATOL = 1e-9


class RecordingAxis:
    """Stands in for a matplotlib axis: keeps each line's points."""

    def __init__(self):
        self.lines = []

    def plot(self, xs, ys, **kwargs):
        self.lines.append(np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64)], 1))


def rows(seed, n=6):
    """Decode rows [cls alpha box2d(4) hwl xyz ry score] in front of the camera."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, 14))
    out[:, 0] = rng.randint(0, 3, n)
    out[:, 2:4] = rng.uniform(0, 900, (n, 2))
    out[:, 4:6] = out[:, 2:4] + rng.uniform(20, 200, (n, 2))
    out[:, 6:9] = rng.uniform([1.4, 1.5, 3.0], [1.8, 2.0, 5.0], (n, 3))
    out[:, 9:12] = np.stack([rng.uniform(-10, 10, n), rng.uniform(1, 2, n),
                             rng.uniform(8, 50, n)], 1)
    out[:, 12] = rng.uniform(-3, 3, n)
    out[:, 13] = rng.uniform(0.2, 1, n)
    return out


def test_gt_corners_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(10):
        dims = rng.uniform([3, 1.4, 1.5], [5, 1.8, 2])
        loc = rng.uniform([-10, 0.5, 5], [10, 2, 50])
        roty = rng.uniform(-3, 3)
        np.testing.assert_allclose(vis.gt_corners(dims, loc, roty),
                                   jax_vis._gt_corners(dims, loc, roty), atol=ATOL)


def test_projected_and_bev_corners_equal_jax():
    """Each row's wireframe (12 edges) and footprint, as the JAX drawing
    functions draw them."""
    calib, jcalib = Calibration(P2), JaxCalibration(P2)
    for row in rows(1):
        h, w, l = row[6:9]
        jcorners = jax_vis.box3d_corners(np.array([l, h, w]), row[9:12], float(row[12]))
        corners = vis.predicted_corners(row)
        np.testing.assert_allclose(corners, jcorners, atol=ATOL)
        uv, depth = vis.projected_corners(calib, corners)
        juv, jdepth = jcalib.project_rect_to_image(jcorners)
        np.testing.assert_allclose(uv, juv, atol=ATOL)
        np.testing.assert_allclose(depth, jdepth, atol=ATOL)
        ax = RecordingAxis()
        jax_vis.draw_box3d_projection(ax, juv)
        edges = [np.stack([uv[i], uv[j]]) for i, j in vis.BOX_EDGES]
        np.testing.assert_allclose(np.stack(edges), np.stack(ax.lines), atol=ATOL)
        ax = RecordingAxis()
        jax_vis.draw_bev_box(ax, jcorners)
        bev = vis.bev_corners(corners)
        np.testing.assert_allclose(np.vstack([bev, bev[:1]]), ax.lines[0], atol=ATOL)


def test_keypoints_and_colours_follow_jax():
    rng = np.random.RandomState(2)
    kp, center, pad = rng.randn(10, 2), rng.uniform(0, 80, 2), np.array([3.0, 5.0])
    np.testing.assert_allclose(vis.keypoints_on_image(kp, center, 4, pad),
                               (kp + center[None]) * 4 - pad[None], atol=ATOL)
    from matplotlib.colors import to_rgb

    def rgb(name):
        return tuple(round(255 * c) for c in to_rgb(name))

    assert [rgb(c) for c in jax_vis.KEYPOINT_COLORS] == [tuple(c) for c in vis.KEYPOINT_COLORS]
    assert {k: rgb(c) for k, c in jax_vis.CLASS_COLORS.items()} == vis.CLASS_COLORS
    assert rgb(jax_vis.GT_COLOR) == vis.GT_COLOR


def test_figure_is_written(tmp_path):
    """Image, bird's-eye and heatmap panels side by side, with ground truth."""
    image = (np.random.RandomState(3).rand(375, 1242, 3) * 255).astype(np.uint8)
    results = rows(4)
    targets = {"reg_mask": np.array([1, 1, 0]), "gt_bboxes": results[:3, 2:6],
               "dimensions": results[:3, [8, 6, 7]], "locations": results[:3, 9:12],
               "rotys": results[:3, 12]}
    heat = np.random.RandomState(5).rand(3, 96, 320).astype(np.float32)
    out = tmp_path / "vis" / "000007.png"
    fig = vis.show_image_with_boxes(image, results, np.ones(6, bool), Calibration(P2),
                                    heatmap=heat, targets=targets,
                                    keypoints=np.zeros((6, 10, 2)), centers=np.ones((6, 2)),
                                    pad_size=np.zeros(2), save_path=str(out))
    assert out.exists()
    with Image.open(out) as png:
        assert png.size == fig.size == (1242 + 375 + round(320 * 375 / 96), 375 + 14)
        pixels = np.asarray(png.convert("RGB"))
    # predictions in their class colours and the ground truth in red, in
    # the bird's-eye panel
    bev = pixels[14:, 1242:1242 + 375].reshape(-1, 3)
    colours = {tuple(c) for c in bev}
    assert vis.GT_COLOR in colours
    assert any(vis.CLASS_COLORS[int(c)] in colours for c in results[:, 0])
    vis.show_heatmap(heat, save_path=str(tmp_path / "hm.png"))
    assert (tmp_path / "hm.png").exists()


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """runs/monoflex.yaml at 96x320 with 16-wide heads on a 1/4-scale tree
    of 50 random frames (10 in val), seeded weights on the CPU."""
    root = tmp_path_factory.mktemp("vis")
    tree = make_synthetic_kitti(str(root / "kitti" / "training"), scale=4, n_random_frames=50)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "runs", "monoflex.yaml"))
    cfg.merge_from_list(["MODEL.HEAD.NUM_CHANNEL", 16, "INPUT.HEIGHT_TEST", 96,
                         "INPUT.WIDTH_TEST", 320, "INPUT.HEIGHT_TRAIN", 96,
                         "INPUT.WIDTH_TRAIN", 320, "TEST.IMS_PER_BATCH", 4,
                         "TEST.VISUALIZE_THRESHOLD", 0.0])
    torch.set_num_threads(2)
    model = build_model(cfg, device="cpu", seed=1)
    return cfg, make_eval_step(model, PostProcessor(cfg)), KITTIDataset(cfg, tree,
                                                                         is_train=False)


def test_inference_writes_at_most_8_pngs(small_run, tmp_path):
    cfg, step, dataset = small_run
    assert len(dataset) == 10
    inference(cfg, step, dataset, str(tmp_path), visualize=True, device="cpu")
    pngs = sorted(os.listdir(tmp_path / "vis"))
    assert pngs == [name for name in dataset.image_files][:8]
    assert len(os.listdir(tmp_path / "data")) == 10
