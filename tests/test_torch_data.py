"""Port parity of the vessel data pipeline (``causalvae_tpu_torch/data/vessel.py``
against ``causalvae_tpu/data/vessel.py``), on the CPU.

Exact: ``synthetic_corpus`` (images, m_raw, m, t_idx, splits; bit for bit),
``_stratified_split``, ``scan_corpus`` (paths, m_raw, m, t_idx, group names,
scaler, splits) on a CSV and a TIFF tree written here, and ``iterate_batches``'
order, m, t and labels.

Masks (``make_preprocess``, and ``x`` of ``iterate_batches``): the
binarized images are equal except at pixels whose min-max normalized value
lies within 1e-5 of their image's mean (the threshold), where the two
resizes' rounding (a few 1e-7 on these shapes) may fall on either side;
those pixels are counted and must be few. The normalized values behind that
rule are JAX's, and the port's antialiased bilinear resize is held to
``jax.image.resize`` within 1e-5 of max|ref| on its own.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.data import vessel as JV

from causalvae_tpu_torch.data import vessel as PV

NEAR = 1e-5  # of the threshold, in normalized units (see the docstring)


def _normalized(raw, aug, hw):
    """JAX's resize, flip and min-max of each image, before the binarize
    (float64 numpy), and each image's mean (inf for a constant image, whose
    mask is all 0 and has no pixel near a threshold)."""
    img = jax.vmap(lambda a: jax.image.resize(a, hw, method="bilinear", antialias=True))(
        jnp.asarray(raw, jnp.float32))
    img = np.asarray(img, np.float64)
    out = []
    for a, m in zip(img, np.asarray(aug)):
        if m in (1, 3):
            a = a[:, ::-1]
        if m in (2, 3):
            a = a[::-1, :]
        lo, hi = a.min(), a.max()
        out.append((a - lo) / (hi - lo) if hi > lo else np.zeros_like(a))
    out = np.stack(out)
    mean = out.mean(axis=(1, 2), keepdims=True)
    flat = (out.max(axis=(1, 2), keepdims=True) == 0.0)
    return out, np.where(flat, np.inf, mean)


def _masks_agree(got, want, raw, aug, hw):
    """Binarized masks equal except within NEAR of the threshold; returns the
    count of pixels near it."""
    got, want = np.asarray(got)[..., 0], np.asarray(want)[..., 0]
    assert got.shape == want.shape
    assert set(np.unique(got)) <= {0.0, 1.0}
    norm, mean = _normalized(raw, aug, hw)
    near = np.abs(norm - mean) <= NEAR
    off = got != want
    assert not (off & ~near).any(), f"{int((off & ~near).sum())} pixels differ away from the threshold"
    assert near.sum() <= 1e-3 * near.size
    return int(near.sum())


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_corpus_is_bit_equal(seed):
    want = JV.synthetic_corpus(n=24, n_groups=5, hw=(48, 80), seed=seed)
    got = PV.synthetic_corpus(n=24, n_groups=5, hw=(48, 80), seed=seed)
    for name in ("raw_images", "m_raw", "m", "t_idx", "scaler_mean", "scaler_scale"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.group_names == want.group_names and got.paths == want.paths
    assert got.splits.keys() == want.splits.keys()
    for k in want.splits:
        assert np.array_equal(got.splits[k], want.splits[k]), k
    np.testing.assert_array_equal(got.one_hot_t(np.arange(4)), want.one_hot_t(np.arange(4)))
    np.testing.assert_array_equal(got.inverse_scale_m(got.m), want.inverse_scale_m(want.m))


@pytest.mark.parametrize("sizes", [(1,), (2,), (3,), (7,), (1, 2, 3, 7), (7, 3, 2, 1, 1)])
def test_stratified_split_matches(sizes):
    rng = np.random.default_rng(len(sizes))
    t_idx = rng.permutation(np.repeat(np.arange(len(sizes)), sizes)).astype(np.int32)
    for seed in (42, 3):
        want, got = JV._stratified_split(t_idx, seed), PV._stratified_split(t_idx, seed)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _write_tiff_f32(path, arr):
    """Minimal little-endian uncompressed float32 TIFF writer (one strip)."""
    h, w = arr.shape
    data = arr.astype("<f4").tobytes()
    n_entries = 8
    data_off = 8 + 2 + n_entries * 12 + 4

    def entry(tag, typ, count, value):
        return struct.pack("<HHII", tag, typ, count, value)

    ifd = struct.pack("<H", n_entries)
    ifd += entry(256, 3, 1, w) + entry(257, 3, 1, h) + entry(258, 3, 1, 32)
    ifd += entry(259, 3, 1, 1) + entry(273, 4, 1, data_off) + entry(278, 3, 1, h)
    ifd += entry(279, 4, 1, len(data)) + entry(339, 3, 1, 3)
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + ifd + data)


def _tiff_corpus(tmp_path):
    """A CSV and a TIFF tree: 15 matched rows in 4 groups, plus rows the scan
    must drop (an empty feature, an "NA" feature, no group, an ID with no
    file, no ID) and files no row names. Feature 9 is constant over the
    matched rows, so its scale becomes 1."""
    rng = np.random.default_rng(5)
    root = tmp_path / "tree"
    lines = [",".join(["Image ID", "group_name", "slide"] + list(JV.FEATURE_COLUMNS))]

    def feats():
        f = [f"{v:.3f}" for v in rng.uniform(0.5, 90.0, 12)]
        f[9] = "1.0"
        return f

    groups = ["ctrl", "dose_b", "dose_a", "sham"]
    ids = []
    for i in range(14):
        img_id = 500100 + 7 * i
        ids.append(img_id)
        sub = root / f"batch{i % 3}"
        sub.mkdir(parents=True, exist_ok=True)
        _write_tiff_f32(sub / f"H{i}-{img_id}.vessel.mip.tiff",
                        rng.random((20, 28)).astype(np.float32))
        lines.append(",".join([str(img_id), groups[i % 4], f"s{i}"] + feats()))
    f = feats()
    lines.append(",".join([str(ids[1]), "ctrl", "dup"] + f))  # a second row of one image
    lines.append(",".join([str(ids[2]), "ctrl", "empty"] + f[:5] + [""] + f[6:]))
    lines.append(",".join([str(ids[3]), "ctrl", "na"] + f[:7] + ["NA"] + f[8:]))
    lines.append(",".join([str(ids[5]), "", "nogroup"] + f))
    lines.append(",".join(["999999", "only_unmatched", "nofile"] + f))  # its group still counts
    lines.append(",".join(["", "ctrl", "noid"] + f))
    for name in ("H99-123456.vessel.mip.tiff", "Hx-notanid.vessel.mip.tiff"):
        _write_tiff_f32(root / name, np.ones((20, 28), np.float32))
    csv_path = tmp_path / "features.csv"
    csv_path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(csv_path), str(root)


def test_scan_corpus_matches_pandas_reading(tmp_path):
    csv_path, root = _tiff_corpus(tmp_path)
    want = JV.scan_corpus(csv_path, root)
    got = PV.scan_corpus(csv_path, root)
    assert got.paths == want.paths and len(got.paths) == 15
    assert got.group_names == [str(g) for g in want.group_names]
    assert "only_unmatched" in got.group_names and got.t_dim == 5
    assert got.raw_images is None
    for name in ("m_raw", "m", "t_idx", "scaler_mean", "scaler_scale"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.scaler_scale[9] == 1.0
    for k in want.splits:
        assert np.array_equal(got.splits[k], want.splits[k]), k
    np.testing.assert_array_equal(PV.load_raw(got.paths[0]), JV.load_raw(want.paths[0]))
    # a file corpus goes through load_raw on the host path
    hw = (16, 24)
    jb = list(JV.iterate_batches(want, "all", 4, hw, augment=False, drop_remainder=False,
                                 use_native=False))
    pb = list(PV.iterate_batches(got, "all", 4, hw, augment=False, drop_remainder=False,
                                 device="cpu"))
    assert [len(b["labels"]) for b in pb] == [len(b["labels"]) for b in jb] == [4, 4, 4, 3]
    for k, (p, j) in enumerate(zip(pb, jb)):
        samples = want.splits["all"][4 * k:4 * k + len(p["labels"])]
        raw = np.stack([JV.load_raw(want.paths[i]) for i in samples])
        np.testing.assert_array_equal(p["labels"], np.asarray(j["labels"]))
        np.testing.assert_array_equal(p["m"].numpy(), np.asarray(j["m"]))
        _masks_agree(p["x"].numpy(), j["x"], raw, np.zeros(len(samples), np.int32), hw)


def _grouped_corpus(tmp_path, groups):
    """A CSV and a TIFF tree whose ``group_name`` column holds ``groups``,
    one matched row each (an empty cell: a row the scan drops), features
    drawn from a seed."""
    rng = np.random.default_rng(11)
    root = tmp_path / "tree"
    root.mkdir()
    lines = [",".join(["Image ID", "group_name"] + list(JV.FEATURE_COLUMNS))]
    for i, g in enumerate(groups):
        img_id = 600100 + 3 * i
        _write_tiff_f32(root / f"H{i}-{img_id}.vessel.mip.tiff",
                        rng.random((12, 16)).astype(np.float32))
        feats = [f"{v:.3f}" for v in rng.uniform(0.5, 90.0, 12)]
        lines.append(",".join([str(img_id), g] + feats))
    csv_path = tmp_path / "features.csv"
    csv_path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(csv_path), str(root)


@pytest.mark.parametrize("kind,cells,names", [
    ("int", ["1", "2", "10"], [1, 2, 10]),
    ("float", ["1.5", "2", "", "10"], [1.5, 2.0, 10.0]),
    ("int_missing", ["1", "2", "", "10"], [1.0, 2.0, 10.0]),
    ("mixed", ["10", "9", "ctrl"], ["10", "9", "ctrl"]),
])
def test_scan_corpus_types_group_names_as_pandas(tmp_path, kind, cells, names):
    """``group_name`` typed as pandas types the column (ints sorted by value,
    a missing cell making them floats, as an all-integer column with one
    missing cell shows, else text): the group names' values,
    types and order, t_idx and the three splits equal JAX's."""
    groups = [cells[i % len(cells)] for i in range(17)]
    csv_path, root = _grouped_corpus(tmp_path, groups)
    want = JV.scan_corpus(csv_path, root)
    got = PV.scan_corpus(csv_path, root)
    assert got.group_names == list(want.group_names) == names
    kinds = {"int": int, "float": float, "int_missing": float, "mixed": str}
    assert all(type(g) is kinds[kind] for g in got.group_names)
    assert all(isinstance(g, (np.integer, int) if kinds[kind] is int else
                          (np.floating, float) if kinds[kind] is float else str)
               for g in want.group_names)
    assert got.paths == want.paths
    assert got.t_idx.dtype == want.t_idx.dtype and np.array_equal(got.t_idx, want.t_idx)
    assert len(set(got.t_idx.tolist())) == len(names)
    for k in ("train", "val", "test", "all"):
        assert np.array_equal(got.splits[k], want.splits[k]), k


@pytest.mark.parametrize("src,dst", [((96, 160), (48, 80)), ((100, 170), (96, 160)),
                                     ((96, 160), (768, 1280))])
def test_make_preprocess_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    masks = PV.synthetic_corpus(n=4, n_groups=3, hw=src, seed=1).raw_images
    raw = np.concatenate([masks, rng.random((4, *src), dtype=np.float32),
                          np.full((1, *src), 0.5, np.float32)])  # a constant image: all 0
    aug = np.array([0, 1, 2, 3, 3, 2, 1, 0, 1], np.int32)
    want = JV.make_preprocess(dst)(jnp.asarray(raw), jnp.asarray(aug))
    got = PV.make_preprocess(dst, "cpu")(torch.from_numpy(raw), torch.from_numpy(aug))
    assert got.shape == (len(raw), *dst, 1) and got.dtype == torch.float32
    _masks_agree(got.numpy()[:-1], want[:-1], raw[:-1], aug[:-1], dst)
    # the constant image: where JAX's resize keeps it constant its mask is 0
    # in both; at 100x170 -> 96x160 both resizes leave a ripple of 1 ulp
    # that min-max blows up into a different pattern on each side
    if not np.asarray(want[-1]).any():
        assert not got[-1].any()
    # the resize alone
    ref = np.asarray(jax.vmap(lambda a: jax.image.resize(
        a, dst, method="bilinear", antialias=True))(jnp.asarray(raw)))
    res = torch.nn.functional.interpolate(torch.from_numpy(raw)[:, None], size=dst,
                                          mode="bilinear", align_corners=False,
                                          antialias=True)[:, 0].numpy()
    assert np.max(np.abs(res - ref)) <= 1e-5 * np.max(np.abs(ref))


@pytest.mark.parametrize("mode,seed,drop", [("train", 1000, True), ("train", 1001, False),
                                            ("val", None, False), ("val", None, True)])
def test_iterate_batches_matches_jax(mode, seed, drop):
    corpus_j = JV.synthetic_corpus(n=40, hw=(96, 160), seed=0)
    corpus_p = PV.synthetic_corpus(n=40, hw=(96, 160), seed=0)
    hw = (48, 80)
    kw = dict(shuffle_seed=seed, drop_remainder=drop)
    if mode == "val":
        kw["augment"] = False
    jb = list(JV.iterate_batches(corpus_j, mode, 8, hw, **kw))
    pb = list(PV.iterate_batches(corpus_p, mode, 8, hw, device="cpu", **kw))
    n = len(corpus_j.splits[mode]) * (4 if mode == "train" else 1)
    assert [len(b["labels"]) for b in pb] == [len(b["labels"]) for b in jb]
    assert sum(len(b["labels"]) for b in pb) == (n - n % 8 if drop else n)
    # the (sample, aug) order of the pair space, read back from JAX's batches
    idx = corpus_j.splits[mode]
    pairs = (np.stack(np.meshgrid(idx, np.arange(4), indexing="ij"), -1).reshape(-1, 2)
             if mode == "train" else np.stack([idx, np.zeros_like(idx)], -1))
    if seed is not None:
        np.random.default_rng(seed).shuffle(pairs)
    s = 0
    for p, j in zip(pb, jb):
        chunk = pairs[s:s + len(p["labels"])]
        s += len(chunk)
        assert set(p) == {"x", "m", "t", "labels"} and isinstance(p["labels"], np.ndarray)
        np.testing.assert_array_equal(p["labels"], np.asarray(j["labels"]))
        np.testing.assert_array_equal(p["labels"], corpus_j.t_idx[chunk[:, 0]])
        np.testing.assert_array_equal(p["m"].numpy(), np.asarray(j["m"]))
        np.testing.assert_array_equal(p["t"].numpy(), np.asarray(j["t"]))
        _masks_agree(p["x"].numpy(), j["x"], corpus_j.raw_images[chunk[:, 0]], chunk[:, 1], hw)


def test_load_raw_names_the_native_loader_without_decoders(monkeypatch, tmp_path):
    """A file the native loader refuses (JPEG compression), without tifffile
    and PIL: load_raw says which file, what the native loader could not read
    and what is missing."""
    import builtins

    real = builtins.__import__

    def no_decoders(name, *args, **kwargs):
        if name.split(".")[0] in ("tifffile", "PIL"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    path = tmp_path / "a.vessel.mip.tiff"
    _write_tiff_f32(path, np.ones((4, 4), np.float32))
    data = bytearray(path.read_bytes())
    at = data.index(struct.pack("<HHII", 259, 3, 1, 1))
    data[at:at + 12] = struct.pack("<HHII", 259, 3, 1, 7)  # Compression: JPEG
    path.write_bytes(bytes(data))
    monkeypatch.setattr(builtins, "__import__", no_decoders)
    with pytest.raises(ValueError, match="native loader") as e:
        PV.load_raw(str(path))
    assert str(path) in str(e.value) and "TIFF tag 259 (Compression) = 7" in str(e.value)
    assert "neither tifffile nor PIL is installed" in str(e.value)
