"""The port's data pipeline against the JAX package's, on the CPU.

The same files (patch packs, patch directories, volumes) written from
seeded numpy go through both packages' sources and tools; batches, tiles
and packs must be equal byte for byte. The crop and augmentation of the
train step are held to the JAX package's `_prepare_batch` with the JAX
draws passed in. These mirror tests/test_data.py and tests/test_volumes.py.
"""

import gzip
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)


def _pack(tmp_path, n=44, size=8, seed=0):
    path = tmp_path / "patches.pack.npy"
    np.save(path, np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), np.uint8))
    return str(path)


def _write_images(d, n=3, h=200, w=300, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            os.path.join(d, f"im{i}.png"))


def _as_numpy(batch):
    return batch.numpy() if isinstance(batch, torch.Tensor) else np.asarray(batch)


# ---------------------------------------------------------------------------
# sources

@pytest.mark.parametrize("epoch", [0, 1])
def test_packed_batches_match_jax_and_ranks_concatenate(tmp_path, epoch):
    """PackedPatchSource: every batch of epochs 0 and 1 equals the JAX
    package's (the same (seed, epoch) permutation, in permutation order),
    and the two ranks' slices concatenate to the global batch."""
    from srgan_st_tpu.data.pipeline import PackedPatchSource as JaxPacked
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource

    pack = _pack(tmp_path)
    want = list(JaxPacked(pack, 8, seed=3, device_cache=False).epoch(epoch))
    got = list(PackedPatchSource(pack, 8, seed=3, device_cache=False).epoch(epoch))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    parts = [list(PackedPatchSource(pack, 8, seed=3, device_cache=False, process_index=r,
                                    process_count=2).epoch(epoch)) for r in range(2)]
    for b, whole in enumerate(got):
        assert parts[0][b].shape[0] == 4
        np.testing.assert_array_equal(np.concatenate([parts[0][b], parts[1][b]]), whole)


@pytest.mark.parametrize("ranks", [1, 2])
def test_resident_pack_equals_host_path(tmp_path, ranks):
    """DEVICE_CACHE on a device ("cpu" here): the pack is copied once and
    each batch gathered there, equal to the host path's batch for every
    rank, epochs 0 and 1, and the index order is the permutation's."""
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource

    pack = _pack(tmp_path)
    for r in range(ranks):
        kw = dict(seed=3, process_index=r, process_count=ranks)
        host = PackedPatchSource(pack, 8, device_cache=False, device="cpu", **kw)
        dev = PackedPatchSource(pack, 8, device_cache=True, device="cpu", **kw)
        for epoch in (0, 1):
            got = list(dev.epoch(epoch))
            want = list(host.epoch(epoch))
            assert all(isinstance(g, torch.Tensor) and g.dtype == torch.uint8 for g in got)
            assert len(got) == len(want) == 5
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
        assert dev.resident().shape == (44, 8, 8, 3)
    arr = np.load(pack)
    order = np.random.default_rng((3, 0)).permutation(44)
    first = next(PackedPatchSource(pack, 8, seed=3, device_cache=True, device="cpu").epoch(0))
    np.testing.assert_array_equal(first.numpy(), arr[order[:8]])


def test_device_cache_auto_gate(tmp_path):
    """"auto" takes the resident pack when the pack's bytes fit the budget;
    --set words are read as booleans."""
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource

    pack = _pack(tmp_path, n=16)  # 3,072 bytes
    assert PackedPatchSource(pack, 4, device_cache="auto", device_cache_budget=3072).device_cache
    assert not PackedPatchSource(pack, 4, device_cache="auto",
                                 device_cache_budget=3071).device_cache
    assert PackedPatchSource(pack, 4, device_cache="true").device_cache
    assert not PackedPatchSource(pack, 4, device_cache="off").device_cache
    with pytest.raises(ValueError, match="DEVICE_CACHE"):
        PackedPatchSource(pack, 4, device_cache="sometimes")


def test_smaller_than_one_batch_raises(tmp_path):
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource, TrainPatchSource

    pack = _pack(tmp_path, n=4)
    with pytest.raises(ValueError, match="smaller than one global batch"):
        PackedPatchSource(pack, batch_size=8)
    d = str(tmp_path / "imgs")
    _write_images(d, n=2, h=96, w=96)
    with pytest.raises(ValueError, match="smaller than one global batch"):
        TrainPatchSource(d, batch_size=4, num_workers=1)


def test_abandoned_epoch_unblocks_producer(tmp_path):
    """Closing an epoch mid-stream lets the prefetch thread exit instead of
    blocking forever on a full queue (packed and directory sources)."""
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource, TrainPatchSource

    d = str(tmp_path / "imgs")
    _write_images(d, n=16, h=8, w=8)
    sources = [PackedPatchSource(_pack(tmp_path, n=64), 4, prefetch=1, device_cache=False),
               TrainPatchSource(d, 4, 8, num_workers=2, prefetch=1)]
    for src in sources:
        before = threading.active_count()
        it = src.epoch(0)
        next(it)
        it.close()
        deadline = time.monotonic() + 5.0
        while threading.active_count() > before:
            assert time.monotonic() < deadline, "producer thread leaked"
            time.sleep(0.05)


def test_train_patch_source_matches_jax(tmp_path):
    """The directory source: batches equal the JAX package's (decode,
    permutation, per-rank slices)."""
    from srgan_st_tpu.data.pipeline import TrainPatchSource as JaxTrain
    from srgan_st_tpu_torch.data.pipeline import TrainPatchSource

    d = str(tmp_path / "imgs")
    _write_images(d, n=8, h=10, w=12)
    for r, count in ((None, None), (0, 2), (1, 2)):
        kw = dict(seed=2, num_workers=2, process_index=r, process_count=count)
        want = list(JaxTrain(d, 4, 8, **kw).epoch(1))
        got = list(TrainPatchSource(d, 4, 8, **kw).epoch(1))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_make_train_source_prefers_pack(tmp_path):
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.data.pipeline import (
        PackedPatchSource, SyntheticPatchSource, TrainPatchSource, make_train_source,
    )

    d = tmp_path / "train"
    _write_images(str(d), n=4, h=96, w=96)
    cfg = Config()
    cfg.DATA.TRAIN_GT_IMAGES_DIR = str(d)
    cfg.DATA.BATCH_SIZE = 2
    assert isinstance(make_train_source(cfg), TrainPatchSource)
    np.save(d / "patches.pack.npy", np.zeros((4, 96, 96, 3), np.uint8))
    src = make_train_source(cfg, device="cpu")
    assert isinstance(src, PackedPatchSource) and src.device_cache
    assert src.device == torch.device("cpu")
    cfg.DATA.TRAIN_GT_IMAGES_DIR = str(d / "patches.pack.npy")
    assert isinstance(make_train_source(cfg), PackedPatchSource)
    cfg.DATA.SYNTHETIC = True
    cfg.DATA.TILE_SIZE = 120
    syn = make_train_source(cfg)
    assert isinstance(syn, SyntheticPatchSource) and next(syn.epoch(0)).shape == (2, 120, 120, 3)


def test_synthetic_ranks_concatenate():
    from srgan_st_tpu.data.pipeline import SyntheticPatchSource as JaxSynthetic
    from srgan_st_tpu_torch.data.pipeline import SyntheticPatchSource

    whole = next(SyntheticPatchSource(8, 16, seed=5).epoch(0))
    np.testing.assert_array_equal(whole, next(JaxSynthetic(8, 16, seed=5).epoch(0)))
    parts = [next(SyntheticPatchSource(8, 16, seed=5, process_index=r,
                                       process_count=2).epoch(0)) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


# ---------------------------------------------------------------------------
# prepare-dataset and volumes

def test_prepare_dataset_tiles_and_pack_match_jax(tmp_path):
    """`prepare-dataset --pack` through the port's CLI writes the same tile
    files and the same pack, byte for byte, as the JAX package's tool."""
    from srgan_st_tpu.data.prepare_dataset import main as jax_main
    from srgan_st_tpu_torch.__main__ import main

    src = str(tmp_path / "orig")
    _write_images(src, n=2, h=200, w=250)
    args = ["--input_dir", src, "--output_size", "96", "--step_size", "80",
            "--num_workers", "2", "--pack"]
    jax_main(args + ["--output_dir", str(tmp_path / "jax")])
    main(["prepare-dataset", *args, "--output_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 2 * 2 * 2 + 1 and "patches.pack.npy" in names
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n
    pack = np.load(tmp_path / "port" / "patches.pack.npy")
    assert pack.shape == (8, 96, 96, 3) and pack.dtype == np.uint8


def _write_nifti(path, vol, gz=False):
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 2.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.5)  # scl_inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.asfortranarray(vol.astype(np.float32)).tobytes(order="F")
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("gz", [False, True])
def test_volumes_match_jax(tmp_path, gz):
    """NIfTI (with scaling), a TIFF stack, slice normalization and the
    slice writer: the port's copy gives the JAX module's arrays and files."""
    from srgan_st_tpu.data import volumes as jv
    from srgan_st_tpu_torch.data import volumes as tv

    rng = np.random.default_rng(4)
    vol = rng.random((6, 5, 4)).astype(np.float32) * 100
    path = str(tmp_path / ("v.nii.gz" if gz else "v.nii"))
    _write_nifti(path, vol, gz=gz)
    (a, ia), (b, ib) = tv.read_nifti(path), jv.read_nifti(path)
    np.testing.assert_array_equal(a, b)
    assert ia == ib
    frames = [(rng.random((8, 10)) * 255).astype(np.uint8) for _ in range(3)]
    tif = str(tmp_path / "stack.tif")
    Image.fromarray(frames[0]).save(tif, save_all=True,
                                    append_images=[Image.fromarray(f) for f in frames[1:]])
    np.testing.assert_array_equal(tv.read_tiff_stack(tif), jv.read_tiff_stack(tif))
    np.testing.assert_array_equal(tv.normalize_slice(vol[0]), jv.normalize_slice(vol[0]))
    n = tv.slice_volume_to_images(vol, str(tmp_path / "p"), axis=1, stride=2)
    assert n == jv.slice_volume_to_images(vol, str(tmp_path / "j"), axis=1, stride=2) == 3
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    with open(tmp_path / "junk.nii", "wb") as f:
        f.write(b"\x00" * 400)
    with pytest.raises(ValueError):
        tv.read_nifti(str(tmp_path / "junk.nii"))


# ---------------------------------------------------------------------------
# crops and augmentation

def _jax_draws(key, b, tile, s, augment):
    """The draws the JAX package's _prepare_batch takes from `key`
    (train/steps.py:131-149), as numpy."""
    k_crop, k_aug = jax.random.split(key)
    out = {}
    if tile != s:
        kh, kw = jax.random.split(k_crop)
        out["offsets"] = tuple(torch.from_numpy(np.array(
            jax.random.randint(k, (b,), 0, tile - s + 1))).long() for k in (kh, kw))
    if augment:
        kf, kr = jax.random.split(k_aug)
        out["flip"] = torch.from_numpy(np.array(jax.random.bernoulli(kf, shape=(b,))))
        out["rot"] = torch.from_numpy(np.array(jax.random.randint(kr, (b,), 0, 4))).long()
    return out


@pytest.mark.parametrize("tile,augment", [(40, True), (32, True), (40, False)])
def test_prepare_batch_matches_jax_given_its_draws(tile, augment):
    """Crop (tiles larger than GT_IMAGE_SIZE) and the dihedral augmentation
    (flip, then rot90^k, per sample): given the offsets, flips and rotation
    counts the JAX package draws, the port's _prepare_batch gives JAX's gt
    and lr exactly, in f32."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.train.steps import _prepare_batch as jax_prepare
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.train.steps import _prepare_batch

    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.DATA.GT_IMAGE_SIZE = 32
    gt = np.random.default_rng(6).integers(0, 256, (8, tile, tile, 3), np.uint8)
    key = jax.random.key(11)
    want_gt, want_lr = jax_prepare(jnp.asarray(gt), jcfg, key, augment)
    draws = _jax_draws(key, 8, tile, 32, augment)
    if augment:
        assert draws["flip"].any() and not draws["flip"].all()
        assert len(set(draws["rot"].tolist())) > 2
    got_gt, got_lr = _prepare_batch(gt, cfg, "cpu", **draws)
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    np.testing.assert_array_equal(got_lr.numpy(), np.asarray(want_lr))


def test_augment_draw_is_seeded_and_differs_per_rank():
    """draw_augment: the same (DATA.SEED + 7, step, rank) gives the same
    draws; another rank or step other draws. They come from a torch
    generator, not jax.random (ROADMAP.md Queue C)."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.train.steps import draw_augment

    cfg = Config()
    a = draw_augment(cfg, 5, 0, 16, (120, 120), True)
    b = draw_augment(cfg, 5, 0, 16, (120, 120), True)
    assert all(torch.equal(x, y) for x, y in zip((*a["offsets"], a["flip"], a["rot"]),
                                                  (*b["offsets"], b["flip"], b["rot"])))
    assert int(a["offsets"][0].max()) <= 24 and int(a["rot"].max()) <= 3
    for other in (draw_augment(cfg, 5, 1, 16, (120, 120), True),
                  draw_augment(cfg, 6, 0, 16, (120, 120), True)):
        assert not torch.equal(a["offsets"][0], other["offsets"][0])
        assert not torch.equal(a["rot"], other["rot"])
    assert draw_augment(cfg, 5, 0, 16, (96, 96), False) == {}
    assert set(draw_augment(cfg, 5, 0, 16, (96, 96), True)) == {"flip", "rot"}


# ---------------------------------------------------------------------------
# warmup() and train() from a pack

@pytest.mark.parametrize("cache", ["true", "false"])
def test_training_runs_from_a_pack(tmp_path, monkeypatch, cache):
    """warmup() and train() from a patches.pack.npy of 104^2 tiles, cropped
    to 96^2 (D's input) and augmented, with DEVICE_CACHE on and off, on the CPU: both
    finish their epoch and write their checkpoints."""
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.train.train import train
    from srgan_st_tpu_torch.train.warmup import warmup

    data = tmp_path / "train"
    data.mkdir()
    np.save(data / "patches.pack.npy",
            np.random.default_rng(0).integers(0, 256, (6, 104, 104, 3), np.uint8))
    monkeypatch.chdir(tmp_path)
    sets = [f"DATA.TRAIN_GT_IMAGES_DIR={data}", "DATA.BATCH_SIZE=2", "DATA.TILE_SIZE=104", "DATA.AUGMENT=true", f"DATA.DEVICE_CACHE={cache}",
            "DATA.SYNTHETIC=false", "MODEL.G_N_RCB=1", "MODEL.G_N_CHANNEL=8",
            "MODEL.D_N_CHANNEL=4", "SOLVER.D_UPDATE_INTERVAL=2", "EXP.N_EPOCHS=1",
            "EXP.NAME=pack", "LOG_TRAIN_PERIOD=1"]
    cfg = apply_overrides(Config(), sets)
    # validation pairs: the seeded synthetic ones, at the GT size
    monkeypatch.setattr("srgan_st_tpu_torch.train.warmup.make_test_pairs",
                        lambda c: _pairs(c))
    monkeypatch.setattr("srgan_st_tpu_torch.train.train.make_test_pairs", lambda c: _pairs(c))
    assert warmup(cfg, device="cpu").step == 3
    state = train(apply_overrides(Config(), sets), device="cpu")
    assert state.step == 3 and state.d_opt.count == 2
    assert {"g_last.npz", "d_last.npz"} <= set(os.listdir(tmp_path / "results" / "pack"))


def _pairs(config):
    from srgan_st_tpu_torch.train.utils import make_test_pairs

    config = type(config)()
    config.DATA.SYNTHETIC = True
    return make_test_pairs(config)
