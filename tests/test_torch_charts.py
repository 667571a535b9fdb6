"""The port's charts (``analysis/plots.py``) read back from their PNGs, and
``utils/metrics.py profile_trace``.

Each PNG is decoded here (zlib, filter 0 rows) and its marks are held to the
data through the chart's own axis map (``plots.Axis``, ``plots.span``):
bar heights within 1 pixel of the values' and in the dict's order, heatmap
cells in the colour map's colours and ordered as the values, a point mark
at each sample's pixel in its class colour and rings on the highlighted
ones, the broken axis's one or two panels by the JAX chart's rule (the
groups of ``tests/test_analysis_pipelines.py``), the feature grid's
min(4, F) columns, the boxes' quartiles at numpy's percentiles (1 pixel).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from causalvae_tpu_torch.analysis import plots
from causalvae_tpu_torch.utils.metrics import profile_trace

M = plots.MARGIN


def read_png(path):
    """(H, W, 3) or (H, W) uint8 of an 8-bit PNG with filter-0 rows."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    ch = {0: 1, 2: 3}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    assert depth == 8 and not rows[:, 0].any()
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _is(img, color):
    return np.all(img == np.asarray(color, np.uint8), axis=-1)


def _runs(mask_1d):
    """Number of maximal runs of True."""
    m = np.asarray(mask_1d, bool)
    return int(m[0]) + int(np.sum(m[1:] & ~m[:-1]))


def _bar_heights(img, y_axis, n, offset, color):
    """Pixel heights of the bars in slots 0..n-1 at ``offset``."""
    out = []
    for i in range(n):
        col = img[:, M + i * plots.SLOT + offset + plots.BAR_W // 2 - 3]
        out.append(int(_is(col, color).sum()))
    return out


def test_ranked_bar_heights_in_dict_order(tmp_path):
    scores = {"z": 0.2, "a": 0.9, "m": 0.45, "b": 0.05, "k": 0.6}  # not sorted
    path = str(tmp_path / "bar.png")
    plots.ranked_bar(scores, path)
    img = read_png(path)
    assert img.shape == (2 * M + plots.PLOT_H, 2 * M + len(scores) * plots.SLOT, 3)
    y = plots.Axis(*plots.span(list(scores.values()), zero=True), M, plots.PLOT_H, flip=True)
    got = _bar_heights(img, y, len(scores), (plots.SLOT - plots.BAR_W) // 2, plots.BAR)
    want = [(plots.PLOT_H - 1) * v / max(scores.values()) + 1 for v in scores.values()]
    assert np.abs(np.subtract(got, want)).max() <= 1.0, (got, want)


def test_phase_comparison_bars(tmp_path):
    comp = {"features": ["f1", "f0", "f2"], "phase1_norm": {"f0": 0.5, "f1": 1.0, "f2": 0.25},
            "phase2_norm": {"f0": 0.75, "f1": 0.1, "f2": 1.0}, "rank_correlation": 0.0}
    path = str(tmp_path / "phase.png")
    plots.phase_comparison_bars(comp, path)
    img = read_png(path)
    for k, (color, key) in enumerate(zip(plots.TAB10[:2], ("phase1_norm", "phase2_norm"))):
        got = _bar_heights(img, None, 3, k * plots.BAR_W, color)
        want = [(plots.PLOT_H - 1) * comp[key][f] + 1 for f in comp["features"]]
        assert np.abs(np.subtract(got, want)).max() <= 1.0, (got, want)


def test_heatmap_cells_coloured_in_value_order(tmp_path):
    m = np.random.default_rng(1).random((5, 7))
    m[2, 3] = np.nan
    path = str(tmp_path / "hm.png")
    plots.heatmap(m, path)
    img = read_png(path)
    assert img.shape == (2 * M + 5 * plots.CELL, 2 * M + 7 * plots.CELL, 3)
    cells = img[M + plots.CELL // 2::plots.CELL, M + plots.CELL // 2::plots.CELL][:5, :7]
    lo, hi = np.nanmin(m), np.nanmax(m)
    want = plots.colormap("viridis", (m - lo) / (hi - lo))
    ok = ~np.isnan(m)
    np.testing.assert_array_equal(cells[ok], want[ok])
    assert np.all(cells[2, 3] == 255)
    # viridis brightens monotonically: the cells' luminance ranks the values
    lum = cells[ok].astype(float) @ np.array([0.299, 0.587, 0.114])
    order = np.argsort(m[ok])
    assert np.all(np.diff(lum[order]) >= 0)
    with pytest.raises(ValueError, match="colour map"):
        plots.heatmap(m, path, cmap="jet")


def test_embedding_scatter_marks_each_sample(tmp_path):
    g = np.arange(4.0)
    emb = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2) * np.array([1.0, 2.5])
    labels = np.arange(16) % 12
    path = str(tmp_path / "emb.png")
    plots.embedding_scatter(emb, labels, path, highlight_idx=[5])
    img = read_png(path)
    ax = plots.Axis(*plots.span(emb[:, 0]), M, plots.SCATTER_W)
    ay = plots.Axis(*plots.span(emb[:, 1]), M, plots.SCATTER_W, flip=True)
    for (x, y), lab in zip(emb, labels):
        assert tuple(img[ay(y), ax(x)]) == plots.TAB10[lab % 10]
    cy, cx = ay(emb[5, 1]), ax(emb[5, 0])
    assert tuple(img[cy, cx + plots.RING]) == plots.RED
    assert tuple(img[cy - plots.RING, cx]) == plots.RED


def test_scatter_diag_points_and_threshold(tmp_path):
    rng = np.random.default_rng(2)
    xs, ys = rng.random(20), rng.random(20)
    path = str(tmp_path / "scatter.png")
    plots.scatter_diag(xs, ys, path, xlabel="sigma", ylabel="r2", hline=1.3)
    img = read_png(path)
    ax = plots.Axis(*plots.span(np.append(xs, 1.3)), M, plots.SCATTER_W)
    ay = plots.Axis(*plots.span(ys), M, plots.PLOT_H, flip=True)
    for x, y in zip(xs, ys):
        assert tuple(img[ay(y), ax(x)]) == plots.TAB10[0]
    column = _is(img[M:M + plots.PLOT_H, ax(1.3)], plots.RED)
    assert 0.4 < column.mean() < 0.8  # dashed


def _panels_down(img):
    """Frames stacked down the left frame column."""
    return _runs(_is(img[:, M - 1], plots.FRAME))


def test_broken_axis_rule_is_jax_s(tmp_path):
    rng = np.random.default_rng(1)
    groups = {f"g{i}": rng.standard_normal((6, 12)) + i for i in range(5)}
    groups["outlier"] = rng.standard_normal((6, 12)) + 40.0
    cases = {"pipeline": {k: v[:, 0] for k, v in groups.items()},
             "two": dict({f"g{i}": rng.random(6) + i + 1 for i in range(5)},
                         outlier=np.array([40.0, 42.0]))}
    for name, mu in cases.items():
        allv = np.concatenate([np.ravel(v) for v in mu.values()])
        cut = np.quantile(allv, 0.9)  # the JAX chart's rule, restated
        broken = allv.max() > cut * 1.5 and np.isfinite(cut)
        assert (plots.broken_axis_split(allv) is not None) == broken
        path = str(tmp_path / f"{name}.png")
        plots.predictions_broken_axis(mu, path, feature_name="Area")
        img = read_png(path)
        assert _panels_down(img) == (2 if broken else 1), name
    assert _panels_down(read_png(str(tmp_path / "pipeline.png"))) == 1
    assert _panels_down(read_png(str(tmp_path / "two.png"))) == 2


def test_feature_grid_columns(tmp_path):
    rng = np.random.default_rng(3)
    groups = {f"g{i}": rng.standard_normal((6, 12)) + i for i in range(5)}
    for n_feat in (12, 3, 5):
        path = str(tmp_path / f"grid{n_feat}.png")
        plots.per_feature_prediction_grid({k: v[:, :n_feat] for k, v in groups.items()},
                                          [f"f{i}" for i in range(n_feat)], path)
        img = read_png(path)
        ncols = min(4, n_feat)
        nrows = -(-n_feat // ncols)
        assert _runs(_is(img[M - 1], plots.FRAME)) == ncols  # the first row's top edges
        assert _panels_down(img) == nrows
        last_top = M + (nrows - 1) * (plots.GRID_PANEL_H + M) - 1
        assert _runs(_is(img[last_top], plots.FRAME)) == n_feat - (nrows - 1) * ncols


def test_overlap_boxes_at_numpy_percentiles(tmp_path):
    rng = np.random.default_rng(4)
    real = {f"g{i}": rng.standard_normal(30) + i for i in range(3)}
    pred = {k: v + 0.5 * rng.standard_normal(30) for k, v in real.items()}
    path = str(tmp_path / "overlap.png")
    plots.overlap_distributions(real, pred, path, feature_name="Area")
    img = read_png(path)
    y = plots.Axis(*plots.span(np.concatenate(list(real.values()) + list(pred.values()))),
                   M, plots.PLOT_H, flip=True)
    for i, name in enumerate(real):
        for k, (values, color) in enumerate(((real[name], plots.BOX_REAL),
                                             (pred[name], plots.BOX_PRED))):
            x0 = M + i * plots.SLOT + k * (plots.BAR_W - 2) + 1
            rows = np.nonzero(_is(img[:, x0], color) | _is(img[:, x0], plots.BLACK))[0]
            q1, med, q3 = np.percentile(values, [25, 50, 75])
            assert abs(rows.min() - y(q3)) <= 1 and abs(rows.max() - y(q1)) <= 1
            assert abs(np.nonzero(_is(img[:, x0], plots.BLACK))[0][0] - y(med)) <= 1
    stats = plots.box_stats(np.r_[np.arange(10.0), 40.0])
    assert stats[-1] == 9.0  # 40 lies beyond 1.5 IQR: the whisker stops at 9


def test_every_chart_is_an_rgb_png(tmp_path):
    rng = np.random.default_rng(0)
    plots.heatmap(rng.random((3, 4)), str(tmp_path / "a.png"))
    plots.heatmap(np.ones((2, 2)), str(tmp_path / "b.png"))
    for name in ("a", "b"):
        assert read_png(str(tmp_path / f"{name}.png")).ndim == 3
    with pytest.raises(ValueError, match="RGB"):
        plots.write_png_rgb(str(tmp_path / "c.png"), np.zeros((2, 2)))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None):
        torch.ones(3).sum()
    d = tmp_path / "trace"
    with profile_trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "aten::mm" in (d / files[0]).read_text()
