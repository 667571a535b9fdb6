"""The port's native IO runtime (``causalvae_tpu_torch/native``) against the
JAX package's (``causalvae_tpu/native``), on the CPU, and the file-backed
vessel paths that use it.

Both libraries are compiled here by the same ``g++`` with the same flags
from sources whose decoders, resampler, transform and loader agree, so the
port is held to JAX bit for bit: ``decode_image`` on every format the
decoder reads, with and without the binarize, flips 0-3, downscaled and
upscaled; ``NativeBatchLoader``'s data and sample indices; and
``iterate_batches(use_native=True)``'s ``x``. ``m``, ``t`` and ``labels``
are equal. ``load_raw`` returns the array written, exactly, with tifffile
and PIL blocked. The one tolerance: the tail batch that
``drop_remainder=False`` finishes on the host path is held as
``tests/test_torch_data.py`` holds that path (masks equal except within 1e-5
of their image's mean, where the two resizes' rounding may fall on either
side). The page walk (``decode_pages``, ``decode_mip``; the JAX loader has
none) is held to PIL's multi-frame reader, bit for bit, on stacks PIL writes
(Deflate, LZW, PackBits, uncompressed; 8- and 16-bit and float32, a NaN
winning the maximum) and chip_smoke's writer writes (every codec, one page
and three); a page unlike the first (size, bit depth, sample format), a
page outside the first page's rules (compression 7) and a loop in the IFD
chain are refused with the page's index and tag. The module skips only
where ``g++`` is absent; a failed build fails.
"""

import gc
import os
import shutil
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from causalvae_tpu import native as JN
from causalvae_tpu.data import vessel as JV

from causalvae_tpu_torch import native as PN
from causalvae_tpu_torch.data import vessel as PV
from test_native import _lzw_encode, _packbits_encode, _write_tiff_ext
from test_torch_data import _masks_agree
from torch_port_helpers import two_threads  # noqa: F401

HW = ((20, 28), (56, 80))  # a downscale and an upscale of the 40x56 files
TIFF_FORMATS = ("f32", "u8", "u16", "lzw8_strips", "lzw16_pred2", "packbits",
                "deflate8_strips", "deflate16_pred2_legacy")
FORMATS = TIFF_FORMATS + ("npy",)


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native loader cannot be built here")
    PN.build()
    assert PN.available() and JN.available(), (PN.build_error(), JN.build_error())


def _pred2(arr):
    """Horizontal differencing (TIFF predictor 2), wrapping in the dtype."""
    diff = arr.copy()
    diff[:, 1:] = arr[:, 1:] - arr[:, :-1]
    return diff


def write_image(path, fmt, arr):
    """Write ``arr`` (2-D, the dtype of ``fmt``) in format ``fmt``."""
    h, w = arr.shape
    if fmt == "npy":
        np.save(path, arr)
    elif fmt == "f32":
        _write_tiff_ext(path, [arr.astype("<f4").tobytes()], w, h, bits=32, compression=1,
                        sample_format=3)
    elif fmt in ("u8", "u16"):
        _write_tiff_ext(path, [arr.astype(arr.dtype.newbyteorder("<")).tobytes()], w, h,
                        bits=8 * arr.itemsize, compression=1)
    elif fmt == "lzw8_strips":
        _write_tiff_ext(path, [_lzw_encode(arr[y:y + 16].tobytes()) for y in range(0, h, 16)],
                        w, h, bits=8, compression=5, rows_per_strip=16)
    elif fmt == "lzw16_pred2":
        _write_tiff_ext(path, [_lzw_encode(_pred2(arr).astype("<u2").tobytes())], w, h,
                        bits=16, compression=5, predictor=2)
    elif fmt == "packbits":
        _write_tiff_ext(path, [_packbits_encode(arr[y:y + 10].tobytes())
                               for y in range(0, h, 10)],
                        w, h, bits=8, compression=32773, rows_per_strip=10)
    elif fmt == "deflate8_strips":
        _write_tiff_ext(path, [zlib.compress(arr[y:y + 16].tobytes()) for y in range(0, h, 16)],
                        w, h, bits=8, compression=8, rows_per_strip=16)
    elif fmt == "deflate16_pred2_legacy":
        _write_tiff_ext(path, [zlib.compress(_pred2(arr).astype("<u2").tobytes(), 1)], w, h,
                        bits=16, compression=32946, predictor=2)
    else:
        raise ValueError(fmt)


def make_array(fmt, rng, shape):
    """Content for ``fmt``: vessel-like runs on a background, with noise."""
    mask = rng.random(shape) > 0.8
    mask |= np.roll(mask, 1, axis=1)  # runs, so LZW and PackBits find repeats
    if fmt in ("f32", "npy"):
        return (mask * rng.uniform(2.0, 9.0) + rng.random(shape)).astype(np.float32)
    if "16" in fmt:
        return (mask * rng.integers(20000, 50000) + rng.integers(0, 3000, shape)).astype(np.uint16)
    return np.where(mask, 200, rng.integers(0, 4, shape) * 20).astype(np.uint8)


@pytest.fixture(scope="module")
def files(built, tmp_path_factory):
    """{format: (path, the array written)}, 40x56 each."""
    root = tmp_path_factory.mktemp("native_formats")
    rng = np.random.default_rng(0)
    out = {}
    for fmt in FORMATS:
        if fmt in ("u16", "lzw16_pred2", "deflate16_pred2_legacy"):
            arr = make_array("16", rng, (40, 56))
        else:
            arr = make_array(fmt, rng, (40, 56))
        path = str(root / f"img-{fmt}.{'npy' if fmt == 'npy' else 'tiff'}")
        write_image(path, fmt, arr)
        out[fmt] = (path, arr)
    return out


def _tasks() -> int:
    return len(os.listdir("/proc/self/task"))


def _within(seconds: float, fn):
    """Run ``fn`` in a thread; fail (not hang) if it does not finish in time."""
    done = []
    t = threading.Thread(target=lambda: done.append(fn()), daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive() and done, f"did not finish in {seconds} s"
    return done[0]


@pytest.mark.parametrize("flip", [0, 1, 2, 3])
@pytest.mark.parametrize("binarize", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_image_equals_jax(files, fmt, binarize, flip):
    path, _ = files[fmt]
    for hw in HW:
        got = PN.decode_image(path, hw, binarize=binarize, flip_mode=flip)
        want = JN.decode_image(path, hw, binarize=binarize, flip_mode=flip)
        assert got is not None and want is not None
        assert got.dtype == np.float32 and got.shape == hw
        assert np.array_equal(got, want), hw


@pytest.mark.parametrize("binarize", [False, True])
def test_batch_loader_equals_jax(files, binarize):
    paths = [files[f][0] for f in FORMATS]
    rng = np.random.default_rng(1)
    order = rng.integers(0, len(paths), 67).astype(np.int32)  # 16 batches of 4, 3 dropped
    augs = rng.integers(0, 4, 67).astype(np.int32)
    kw = dict(augs=augs, binarize=binarize, n_threads=4, max_queue=3)
    port = PN.NativeBatchLoader(paths, order, (20, 28), 4, **kw)
    jax_ = JN.NativeBatchLoader(paths, order, (20, 28), 4, **kw)
    try:
        got, want = list(port), list(jax_)
    finally:
        port.close()
        jax_.close()
    assert len(got) == len(want) == 16
    for (x, idx), (xj, idxj) in zip(got, want):
        assert x.shape == (4, 20, 28, 1) and idx.dtype == np.int32
        assert np.array_equal(x, xj) and np.array_equal(idx, idxj)
    np.testing.assert_array_equal(np.concatenate([i for _, i in got]), order[:64])


def test_loader_missing_file_yields_zeros(files, tmp_path):
    loader = PN.NativeBatchLoader([files["u8"][0], str(tmp_path / "missing.tiff")],
                                  np.asarray([1, 1, 0, 0], np.int32), (8, 8), 2,
                                  binarize=False)
    (a, ia), (b, ib) = list(loader)
    loader.close()
    np.testing.assert_array_equal(ia, [1, 1])
    np.testing.assert_array_equal(a, 0.0)
    assert b.max() == 1.0


def test_abandoned_loader_joins_its_threads(files):
    """An iterator dropped after one batch, with later batches decoded and
    waiting, frees the loader and joins its threads."""
    paths = [files[f][0] for f in FORMATS]

    def abandon():
        before = _tasks()
        loader = PN.NativeBatchLoader(paths, np.arange(400, dtype=np.int32) % len(paths),
                                      (56, 80), 4, n_threads=4, max_queue=2)
        assert _tasks() == before + 4
        next(iter(loader))
        del loader
        gc.collect()
        return _tasks() - before

    assert _within(60, abandon) == 0


def test_loader_rejects_an_order_outside_the_paths(files):
    with pytest.raises(ValueError, match="order"):
        PN.NativeBatchLoader([files["u8"][0]], np.asarray([0, 1], np.int32), (8, 8), 2)


@pytest.fixture
def no_decoders(monkeypatch):
    """tifffile and PIL cannot be imported."""
    for name in ("tifffile", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_raw_without_tifffile_or_pil(files, fmt, monkeypatch):
    """``load_raw`` returns the array written; PIL (where it reads the
    format) decodes the same file to the same array."""
    path, arr = files[fmt]
    if fmt != "npy":
        from PIL import Image

        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im, np.float32), arr.astype(np.float32))
    for name in ("tifffile", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    got = PV.load_raw(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, arr.astype(np.float32))


@pytest.mark.parametrize("tags,named", [
    (dict(bits=8, compression=7), r"TIFF tag 259 \(Compression\) = 7"),
    (dict(bits=1, compression=1), r"TIFF tag 258 \(BitsPerSample\) = 1"),
    (dict(bits=16, compression=1, sample_format=2), r"TIFF tag 339 \(SampleFormat\) = 2"),
    (dict(bits=8, compression=5, predictor=3), r"TIFF tag 317 \(Predictor\) = 3"),
])
def test_load_raw_names_the_tag_it_cannot_read(built, tmp_path, no_decoders, tags, named):
    path = str(tmp_path / "refused.tiff")
    _write_tiff_ext(path, [bytes(2 * 10 * 10)], 10, 10, **tags)
    assert PN.decode_image(path, (4, 4)) is None  # the loader's zeros
    with pytest.raises(ValueError, match=named) as e:
        PV.load_raw(path)
    assert path in str(e.value) and "tifffile nor PIL" in str(e.value)


def test_load_raw_missing_file_raises(built, tmp_path):
    with pytest.raises(FileNotFoundError):
        PV.load_raw(str(tmp_path / "missing.vessel.mip.tiff"))


def _write_corpus(root, fmts, n_groups=3, per_group=5, shape=(60, 100), seed=3):
    """A CSV and ``*.vessel.mip.tiff`` files named by image ID (the
    reference's layout), formats taken in turn from ``fmts``; returns the
    CSV's path and {path: array written}."""
    rng = np.random.default_rng(seed)
    header = "Image ID,group_name," + ",".join(
        f'"{c}"' if "," in c else c for c in PV.FEATURE_COLUMNS)
    lines, arrays = [header], {}
    for i in range(n_groups * per_group):
        img_id = 600001 + i
        fmt = fmts[i % len(fmts)]
        arr = make_array(fmt, rng, shape)
        path = str(root / f"H11-{img_id}.vessel.mip.tiff")
        write_image(path, fmt, arr)
        arrays[path] = arr.astype(np.float32)
        feats = rng.uniform(1.0, 100.0, len(PV.FEATURE_COLUMNS)) + 10.0 * (i % n_groups)
        lines.append(f"{img_id},group_{i % n_groups}," + ",".join(f"{v:.4f}" for v in feats))
    csv_path = root / "vessel_meta.csv"
    csv_path.write_text("\n".join(lines) + "\n")
    return str(csv_path), arrays


@pytest.fixture(scope="module")
def corpus_files(built, tmp_path_factory):
    root = tmp_path_factory.mktemp("native_corpus")
    csv_path, arrays = _write_corpus(root, ("lzw16_pred2", "deflate16_pred2_legacy", "u8",
                                            "f32", "lzw8_strips"))
    return csv_path, str(root), arrays


def _pairs(corpus, mode, seed):
    """The (sample, aug) pairs in ``iterate_batches``' order."""
    idx = corpus.splits[mode]
    pairs = (np.stack(np.meshgrid(idx, np.arange(4), indexing="ij"), -1).reshape(-1, 2)
             if mode == "train" else np.stack([idx, np.zeros_like(idx)], -1))
    if seed is not None:
        np.random.default_rng(seed).shuffle(pairs)
    return pairs


@pytest.mark.parametrize("mode,seed,drop,b", [("train", 1000, True, 8), ("train", 1001, False, 8),
                                              ("val", None, False, 2)])
def test_iterate_batches_native_equals_jax(corpus_files, mode, seed, drop, b):
    """The native batches bit for bit; the host-path tail as
    ``tests/test_torch_data.py`` holds that path."""
    csv_path, root, arrays = corpus_files
    cj, cp = JV.scan_corpus(csv_path, root), PV.scan_corpus(csv_path, root)
    assert cp.raw_images is None and cp.paths == cj.paths
    hw = (48, 80)
    kw = dict(shuffle_seed=seed, drop_remainder=drop, use_native=True)
    if mode == "val":
        kw["augment"] = False
    jb = list(JV.iterate_batches(cj, mode, b, hw, **kw))
    pb = list(PV.iterate_batches(cp, mode, b, hw, device="cpu", **kw))
    pairs = _pairs(cj, mode, seed)
    tail = 0 if drop else len(pairs) % b
    assert tail or drop  # each case without drop has a tail on this corpus
    assert len(pb) == len(jb) == len(pairs) // b + bool(tail)
    assert [len(p["labels"]) for p in pb] == [len(j["labels"]) for j in jb]
    for k, (p, j) in enumerate(zip(pb, jb)):
        np.testing.assert_array_equal(p["labels"], np.asarray(j["labels"]))
        np.testing.assert_array_equal(p["m"].numpy(), np.asarray(j["m"]))
        np.testing.assert_array_equal(p["t"].numpy(), np.asarray(j["t"]))
        if tail and k == len(pb) - 1:
            chunk = pairs[len(pairs) - tail:]
            np.testing.assert_array_equal(p["labels"], cj.t_idx[chunk[:, 0]])
            raw = np.stack([arrays[cj.paths[s]] for s in chunk[:, 0]])
            _masks_agree(p["x"].numpy(), j["x"], raw, chunk[:, 1], hw)
        else:
            assert p["x"].dtype == torch.float32 and p["x"].shape == (b, *hw, 1)
            assert np.array_equal(p["x"].numpy(), np.asarray(j["x"]))


def test_iterate_batches_chooses_the_route_as_jax(corpus_files):
    """``use_native=None``: the native route for a file-backed corpus (its
    batches equal ``use_native=True``'s; the host path's agree as the tail's
    do), the host path for an in-memory one (equal to
    ``use_native=False``'s); an abandoned native iterator joins the
    loader's threads."""
    csv_path, root, arrays = corpus_files
    cp = PV.scan_corpus(csv_path, root)
    before = _tasks()
    kw = dict(shuffle_seed=0, device="cpu")
    auto = next(PV.iterate_batches(cp, "train", 4, (48, 80), **kw))
    assert _tasks() == before
    native = next(PV.iterate_batches(cp, "train", 4, (48, 80), use_native=True, **kw))
    host = next(PV.iterate_batches(cp, "train", 4, (48, 80), use_native=False, **kw))
    assert torch.equal(auto["x"], native["x"])
    chunk = _pairs(cp, "train", 0)[:4]
    _masks_agree(host["x"].numpy(), native["x"].numpy(),
                 np.stack([arrays[cp.paths[s]] for s in chunk[:, 0]]), chunk[:, 1], (48, 80))
    mem = PV.synthetic_corpus(n=12, hw=(48, 80), seed=0)
    a = next(PV.iterate_batches(mem, "train", 4, (24, 40), **kw))
    b = next(PV.iterate_batches(mem, "train", 4, (24, 40), use_native=False, **kw))
    assert torch.equal(a["x"], b["x"])


def test_cli_train_vessel_on_an_lzw_corpus_without_tifffile_or_pil(tmp_path, no_decoders,
                                                                   monkeypatch):
    """``train vessel --csv --data`` takes the native route by default
    (the sample-recon probe, the train epoch) and finishes the val tail on
    the host path, with tifffile and PIL blocked."""
    from causalvae_tpu_torch.cli.main import main

    csv_path, _ = _write_corpus(tmp_path, ("lzw8_strips",), per_group=3, shape=(48, 80))
    made = []
    real = PN.NativeBatchLoader

    class Counted(real):
        def __init__(self, *args, **kwargs):
            made.append(args[3])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(PN, "NativeBatchLoader", Counted)
    model, _, log = main(["--out", str(tmp_path / "out"), "train", "vessel", "--csv", csv_path,
                          "--data", str(tmp_path), "--img-hw", "96", "160", "--device", "cpu",
                          "--epochs", "1"])
    assert made == [2, 8, 8]  # the probe; the train epoch; the val batches (all tail)
    assert log.clock.records[0]["steps"] == 1  # 3 train samples x 4 augs, batch 8
    assert np.isfinite(log.history[0]["train_loss"]) and np.isfinite(log.history[1]["val_loss"])
    run = tmp_path / "out" / "train_vessel"
    for name in ("metrics.jsonl", "latest.pt", "best.pt"):
        assert (run / name).exists(), name


@pytest.mark.parametrize("fmt", sorted(chip_smoke.FILE_CODECS))
def test_chip_smoke_tiff_writer_is_read_by_pil_and_the_native_loader(built, tmp_path, fmt):
    """The TIFF writer of the card check's file corpus (its own LZW and
    PackBits encoders among them): PIL (libtiff) and ``load_raw`` read back
    the array written, exactly. The image crosses LZW's table resets, has
    runs longer than a PackBits packet and a short last strip."""
    rng = np.random.default_rng(5)
    u16 = np.repeat(rng.integers(0, 65536, (150, 50)), 4, axis=1).astype(np.uint16)
    u16[:10] = 7
    arr = {"f32": (u16 / np.float32(65535)).astype(np.float32)}.get(fmt, u16)
    if fmt in ("lzw8", "packbits", "u8"):
        arr = (u16 >> 8).astype(np.uint8)
    path = str(tmp_path / f"{fmt}.tiff")
    chip_smoke.write_tiff(path, arr, *chip_smoke.FILE_CODECS[fmt])
    from PIL import Image

    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
    np.testing.assert_array_equal(PV.load_raw(path), arr.astype(np.float32))


def test_cli_kfold_preloads_the_file_corpus_in_order(tmp_path, no_decoders):
    """``kfold`` on a file corpus decodes every file (in threads) into the
    corpus order: its preprocessed images equal ``make_preprocess`` of the
    arrays written, bit for bit, with tifffile and PIL blocked."""
    from causalvae_tpu_torch.cli.main import main

    csv_path, arrays = _write_corpus(tmp_path, ("lzw16_pred2", "deflate8_strips", "f32"),
                                     per_group=4, shape=(48, 80))
    corpus = PV.scan_corpus(csv_path, str(tmp_path))
    models, _, data, history = main(["--out", str(tmp_path / "out"), "kfold", "--folds", "2",
                                     "--epochs", "1", "--img-hw", "96", "160", "--device", "cpu",
                                     "--csv", csv_path, "--data", str(tmp_path)])
    raw = torch.from_numpy(np.stack([arrays[p] for p in corpus.paths]))
    want = PV.make_preprocess((96, 160), "cpu")(raw, torch.zeros(len(raw), dtype=torch.int32))
    assert torch.equal(data["x"], want)
    assert np.isfinite(history[0]["train"]["loss"]).all()


# --- the page walk: multi-page TIFF stacks (decode_pages, decode_mip) -------

PIL_CODECS = {"deflate": "tiff_deflate", "lzw": "tiff_lzw", "packbits": "packbits",
              "none": None}
STACK_DTYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}


def _pil_frames(path):
    from PIL import Image

    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im, np.float32))
    return np.stack(frames)


@pytest.mark.parametrize("dtype", sorted(STACK_DTYPES))
@pytest.mark.parametrize("codec", sorted(PIL_CODECS))
def test_page_walk_equals_pil_multiframe(built, tmp_path, monkeypatch, codec, dtype):
    """A 5-page stack written by PIL (``save_all``): ``decode_pages`` equals
    PIL's frames and ``decode_mip`` their maximum, bit for bit, with
    tifffile and PIL blocked for the decode; a float page's NaN wins the
    maximum, as in ``numpy.max``."""
    from PIL import Image

    rng = np.random.default_rng(11)
    hi = {"u8": 256, "u16": 65536, "f32": 1000}[dtype]
    stack = rng.integers(0, hi, (5, 37, 53)).astype(STACK_DTYPES[dtype])
    if dtype == "f32":
        stack = stack * np.float32(0.37)
        stack[2, 3, 4] = np.nan
    path = str(tmp_path / f"stack_{codec}_{dtype}.tif")
    frames = [Image.fromarray(a) for a in stack]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   compression=PIL_CODECS[codec])
    want = _pil_frames(path)
    np.testing.assert_array_equal(want, stack.astype(np.float32))
    for name in ("tifffile", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    got = PN.decode_pages(path)
    assert got.dtype == np.float32 and got.shape == (5, 37, 53)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PN.decode_mip(path), want.max(axis=0))
    np.testing.assert_array_equal(PN.decode_raw(path), want[0])


@pytest.mark.parametrize("fmt", sorted(chip_smoke.FILE_CODECS))
@pytest.mark.parametrize("pages", [1, 3])
def test_chip_smoke_stack_writer_and_one_page_files(built, tmp_path, fmt, pages):
    """chip_smoke's TIFF writer with a (P, h, w) array: PIL reads back every
    page, and the page walk equals it; a one-page file gives the same image
    through ``decode_raw``, ``decode_pages`` ((1, h, w)) and ``decode_mip``."""
    rng = np.random.default_rng(pages)
    u16 = rng.integers(0, 65536, (pages, 70, 30)).astype(np.uint16)
    arr = {"f32": (u16 / np.float32(65535)).astype(np.float32)}.get(fmt, u16)
    if fmt in ("lzw8", "packbits", "u8"):
        arr = (u16 >> 8).astype(np.uint8)
    path = str(tmp_path / f"{fmt}.tiff")
    chip_smoke.write_tiff(path, arr if pages > 1 else arr[0], *chip_smoke.FILE_CODECS[fmt],
                          rows=16)
    want = arr.astype(np.float32)
    np.testing.assert_array_equal(_pil_frames(path), want)
    np.testing.assert_array_equal(PN.decode_pages(path), want)
    np.testing.assert_array_equal(PN.decode_mip(path), want.max(axis=0))
    np.testing.assert_array_equal(PN.decode_raw(path), want[0])


@pytest.mark.parametrize("other,named", [
    (np.zeros((11, 12), np.uint8), r"page 1: TIFF tag 257 \(ImageLength\) = 11 differs "
                                   r"from page 0's 10"),
    (np.zeros((10, 13), np.uint8), r"page 1: TIFF tag 256 \(ImageWidth\) = 13"),
    (np.zeros((10, 12), np.uint16), r"page 1: TIFF tag 258 \(BitsPerSample\) = 16"),
    (np.zeros((10, 12), np.float32), r"page 1: TIFF tag 258 \(BitsPerSample\) = 32"),
], ids=["length", "width", "bits", "float"])
def test_page_walk_refuses_a_page_unlike_the_first(built, tmp_path, other, named):
    from PIL import Image

    path = str(tmp_path / "mixed.tif")
    Image.fromarray(np.zeros((10, 12), np.uint8)).save(
        path, save_all=True, append_images=[Image.fromarray(other)])
    for fn in (PN.decode_pages, PN.decode_mip):
        with pytest.raises(ValueError, match=named) as e:
            fn(path)
        assert path in str(e.value)
    assert PN.decode_raw(path).shape == (10, 12)  # the first page alone still reads


def _ifds(data: bytes):
    """The IFD offsets of a little-endian TIFF, in chain order."""
    import struct

    out, off = [], struct.unpack_from("<I", data, 4)[0]
    while off and off not in out:
        out.append(off)
        n = struct.unpack_from("<H", data, off)[0]
        off = struct.unpack_from("<I", data, off + 2 + 12 * n)[0]
    return out


def _patched(tmp_path, patch):
    """A 3-page deflate stack by chip_smoke's writer, ``patch(data, ifds)``
    applied to its bytes."""
    path = str(tmp_path / "patched.tiff")
    arr = np.arange(3 * 8 * 6, dtype=np.uint16).reshape(3, 8, 6)
    chip_smoke.write_tiff(path, arr, 8, 2, rows=4)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    patch(data, _ifds(bytes(data)))
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("target,named", [
    (0, r"page 3: the IFD chain loops \(offset \d+ is page 0's IFD\)"),
    (2, r"page 3: the IFD chain loops \(offset \d+ is page 2's IFD\)"),
], ids=["to_the_first", "to_itself"])
def test_page_walk_refuses_a_loop_in_the_chain(built, tmp_path, target, named):
    import struct

    def loop(data, ifds):
        n = struct.unpack_from("<H", data, ifds[2])[0]
        struct.pack_into("<I", data, ifds[2] + 2 + 12 * n, ifds[target])

    path = _patched(tmp_path, loop)
    for fn in (PN.decode_pages, PN.decode_mip):
        with pytest.raises(ValueError, match=named):
            fn(path)


def test_page_walk_checks_every_page_as_the_first(built, tmp_path):
    """Page 1 with compression 7 (JPEG) is refused by the first page's rule,
    its index and tag named."""
    import struct

    def jpeg(data, ifds):
        n = struct.unpack_from("<H", data, ifds[1])[0]
        for e in range(n):
            at = ifds[1] + 2 + 12 * e
            if struct.unpack_from("<H", data, at)[0] == 259:
                struct.pack_into("<H", data, at + 8, 7)

    path = _patched(tmp_path, jpeg)
    with pytest.raises(ValueError, match=r"page 1: TIFF tag 259 \(Compression\) = 7"):
        PN.decode_pages(path)
    assert PN.decode_raw(path).shape == (8, 6)
