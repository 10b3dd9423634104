"""The port's data path on the CPU against the JAX package's.

* WAV codec: round trips (int16 within 2/32768, float32 exact), written bytes
  equal to JAX's ``write_wav``, and every encoding the readers take (PCM
  8/16/24/32, IEEE float32/64, the extensible tag) read bit for bit alike by
  the port's numpy reader, the JAX reader and the native decoder;
* the native library (the port's own build of native/msla_io.cpp): decode and
  frame index bit-equal to the plain versions and to JAX's binding, the
  resampler bit-equal to JAX's binding and within rtol 1e-4, atol 1e-5 of
  scipy (the same filter family in another order); a failed build raises;
* ``SlakhDataset``: frames, ``dataset_dict.json`` and the cached tensors
  bit-equal to JAX's on one fixture, at 4 kHz and resampled 44.1 → 22 kHz;
  the skip rules and the ``max_duration`` cap as JAX applies them;
* ``DataLoader``: batches bit-equal to JAX's for one seed over two epochs,
  with ``drop_last``, the background thread, the process interleave, and an
  abandoned iterator's producer stopping;
* the datamodule's four loaders against JAX's, batch for batch.
"""
import json
import struct
import threading
import time

import numpy as np
import pytest

from msla_tpu.data import native as jax_native
from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.data.dataset import SlakhDataset as JaxSlakhDataset
from msla_tpu.data.dataset import make_fixture_dataset as jax_make_fixture_dataset
from msla_tpu.data.loader import DataLoader as JaxDataLoader
from msla_tpu.data.wavio import read_wav as jax_read_wav
from msla_tpu.data.wavio import write_wav as jax_write_wav
from msla_tpu_torch.data import native
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.data.dataset import STEM_NAMES, SlakhDataset, make_fixture_dataset
from msla_tpu_torch.data.loader import DataLoader
from msla_tpu_torch.data.resample import resample as plain_resample
from msla_tpu_torch.data.wavio import read_wav, write_wav

SR = 4000


def _wav_bytes(samples: np.ndarray, rate: int, tag: int, bits: int,
               extensible: bool = False, channels: int | None = None) -> bytes:
    """A WAV file of interleaved (frames, channels) integer or float samples
    (24-bit PCM: (frames, 3·channels) bytes)."""
    channels = channels or samples.shape[1]
    payload = samples.tobytes()
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels, rate,
                      rate * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) + b"\x00" * 14
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _encoded(kind: str, rng) -> tuple[bytes, int]:
    n, ch = 1001, 2
    if kind == "pcm8":
        return _wav_bytes(rng.integers(0, 256, (n, ch), dtype=np.uint8), 8000, 1, 8), ch
    if kind == "pcm16":
        return _wav_bytes(rng.integers(-32768, 32768, (n, ch)).astype("<i2"), 8000, 1, 16), ch
    if kind == "pcm24":
        raw = rng.integers(0, 256, (n, ch * 3), dtype=np.uint8)
        return _wav_bytes(raw, 8000, 1, 24, channels=ch), ch
    if kind == "pcm32":
        return _wav_bytes(rng.integers(-2**31, 2**31, (n, ch)).astype("<i4"), 8000, 1, 32), ch
    if kind == "float32":
        return _wav_bytes(rng.uniform(-1, 1, (n, ch)).astype("<f4"), 8000, 3, 32), ch
    if kind == "float64":
        return _wav_bytes(rng.uniform(-1, 1, (n, ch)).astype("<f8"), 8000, 3, 64), ch
    if kind == "extensible_pcm16":
        return _wav_bytes(rng.integers(-32768, 32768, (n, ch)).astype("<i2"), 8000, 1, 16,
                          extensible=True), ch
    raise ValueError(kind)


ENCODINGS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64", "extensible_pcm16"]


@pytest.mark.parametrize("dtype,atol", [("int16", 2.0 / 32768), ("float32", 0.0)])
def test_wav_round_trip(tmp_path, dtype, atol):
    x = np.random.default_rng(0).uniform(-0.9, 0.9, (2, 1000)).astype(np.float32)
    write_wav(tmp_path / "x.wav", x, 22000, dtype=dtype)
    y, sr = read_wav(tmp_path / "x.wav")
    assert sr == 22000 and y.shape == (2, 1000) and y.dtype == np.float32
    np.testing.assert_allclose(y, x, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("shape", [(1000,), (2, 777)])
def test_write_wav_bytes_equal_jax(tmp_path, dtype, shape):
    x = np.random.default_rng(1).uniform(-1.2, 1.2, shape).astype(np.float32)
    write_wav(tmp_path / "port.wav", x, 44100, dtype=dtype)
    jax_write_wav(tmp_path / "jax.wav", x, 44100, dtype=dtype)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("kind", ENCODINGS)
def test_every_encoding_reads_alike(tmp_path, kind):
    data, ch = _encoded(kind, np.random.default_rng(ENCODINGS.index(kind)))
    path = tmp_path / f"{kind}.wav"
    path.write_bytes(data)
    plain, sr = read_wav(path)
    want, jax_sr = jax_read_wav(path)
    nat, nat_sr = native.read_wav(path)
    assert sr == jax_sr == nat_sr == 8000 and plain.shape == (ch, 1001)
    assert plain.dtype == nat.dtype == np.float32
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(nat, plain)


def test_native_library_is_built_in_the_build_dir():
    lib = native.get_lib()
    assert native.LIB_PATH.parts[-3:] == ("build", "msla_tpu_torch", "libmsla_io.so")
    assert native.LIB_PATH.exists() and lib._name == str(native.LIB_PATH)
    assert native.LIB_PATH.with_suffix(".stamp").read_text() == native._stamp()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libmsla_io.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.read_wav(tmp_path / "x.wav")


def test_an_unreadable_file_raises_and_does_not_fall_back(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVE")
    with pytest.raises(ValueError, match="msla_wav_info"):
        native.read_wav(bad)
    weird = tmp_path / "pcm12.wav"
    weird.write_bytes(_wav_bytes(np.zeros((10, 1), "<i2"), 8000, 1, 12))
    with pytest.raises(ValueError, match="msla_decode_wav"):
        native.read_wav(weird)


@pytest.mark.parametrize("rates", [(44100, 22000), (22000, 44100), (48000, 22000),
                                   (8000, 4000)])
@pytest.mark.parametrize("shape", [(5000,), (3, 4410)])
def test_native_resample(rates, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = native.resample(x, *rates)
    np.testing.assert_array_equal(got, jax_native.resample(x, *rates))
    want = plain_resample(x, *rates)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _frame_index_plain(stems, sr, frame_len, max_duration):
    out = []
    for sub in range(max_duration):
        start, end = sub * sr, sub * sr + frame_len
        if end > stems.shape[1] or int(stems[:, start:end].sum()) == 0:
            continue
        out.append(start)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("max_duration", [5, 20])
def test_native_frame_index(max_duration):
    rng = np.random.default_rng(3)
    stems = rng.standard_normal((4, 10 * 1000)).astype(np.float32) + 0.01
    stems[:, 3000:5000] = 0.0  # a silent window
    got = native.frame_index(stems, 1000, 2000, max_duration)
    np.testing.assert_array_equal(got, _frame_index_plain(stems, 1000, 2000, max_duration))
    np.testing.assert_array_equal(got, jax_native.frame_index(stems, 1000, 2000, max_duration))


def _pair_of_fixtures(root, n_tracks, seconds, sr):
    jax_make_fixture_dataset(root / "jax", n_tracks=n_tracks, seconds=seconds, sr=sr, seed=5)
    make_fixture_dataset(root / "port", n_tracks=n_tracks, seconds=seconds, sr=sr, seed=5)
    return root / "jax", root / "port"


def _ds_kw(**kw):
    return dict(dict(target_sample_duration=2, target_sample_rate=SR, max_duration=120,
                     maximum_dataset_size=150000), **kw)


@pytest.mark.parametrize("fixture_sr,target_sr", [(SR, SR), (44100, 22000)])
def test_dataset_bit_equal_to_jax(tmp_path, fixture_sr, target_sr):
    jax_dir, port_dir = _pair_of_fixtures(tmp_path, 2, 24, fixture_sr)
    for name in STEM_NAMES:  # the fixture writer is the JAX package's
        assert ((jax_dir / "Track00001" / f"{name}.wav").read_bytes()
                == (port_dir / "Track00001" / f"{name}.wav").read_bytes())
    kw = _ds_kw(target_sample_rate=target_sr)
    want, got = JaxSlakhDataset(str(jax_dir), **kw), SlakhDataset(str(port_dir), **kw)
    assert (port_dir / "dataset_dict.json").read_bytes() == \
        (jax_dir / "dataset_dict.json").read_bytes()
    for idx in range(2):
        assert (port_dir / f"tensor_{idx}.npy").read_bytes() == \
            (jax_dir / f"tensor_{idx}.npy").read_bytes()
    assert len(got) == len(want) == 2 * 3  # 4 s after the trims: starts 0, 1, 2 s
    for i in range(len(got)):
        assert got[i].shape == (4, 2 * target_sr) and got[i].dtype == np.float32
        np.testing.assert_array_equal(got[i], want[i])
    again = SlakhDataset(str(port_dir), **kw)  # the second build reads the caches
    assert again.data_list == got.data_list


def _odd_tracks(root):
    """A bass-only track, an all-silent one and a good one, as JAX's test has them."""
    t = np.arange(26 * SR) / SR
    solo = root / "Track00000"
    solo.mkdir(parents=True)
    jax_write_wav(solo / "bass.wav", 0.4 * np.sin(2 * np.pi * 110 * t).astype(np.float32), SR)
    silent = root / "Track00001"
    silent.mkdir()
    for name in STEM_NAMES:
        jax_write_wav(silent / f"{name}.wav", np.zeros(26 * SR, np.float32), SR)
    good = root / "Track00002"
    good.mkdir()
    rng = np.random.default_rng(4)
    for j, name in enumerate(STEM_NAMES):
        wave = 0.4 * np.sin(2 * np.pi * 110 * (2 ** j) * t) + 0.05 * rng.standard_normal(t.shape)
        jax_write_wav(good / f"{name}.wav", (wave + 0.02).astype(np.float32), SR)


def test_skips_single_instrument_and_silent_tracks_as_jax(tmp_path):
    for side in ("jax", "port"):
        _odd_tracks(tmp_path / side)
    want = JaxSlakhDataset(str(tmp_path / "jax"), **_ds_kw())
    got = SlakhDataset(str(tmp_path / "port"), **_ds_kw())
    assert got.data_list == want.data_list
    assert {e["file_path_idx"] for e in got.data_list} == {2}
    assert got.file_paths == [str(tmp_path / "port" / "Track00002")]
    assert not (tmp_path / "port" / "tensor_0.npy").exists()
    assert not (tmp_path / "port" / "tensor_1.npy").exists()


@pytest.mark.parametrize("max_duration,frames", [(15, 14), (120, 19), (7, 6)])
def test_max_duration_cap_as_jax(tmp_path, max_duration, frames):
    jax_dir, port_dir = _pair_of_fixtures(tmp_path, 1, 40, SR)
    kw = _ds_kw(max_duration=max_duration)
    want, got = JaxSlakhDataset(str(jax_dir), **kw), SlakhDataset(str(port_dir), **kw)
    assert len(got) == len(want) == frames  # 40 - 20 s of trims, capped, 1 s hop
    assert got.data_list == want.data_list
    np.testing.assert_array_equal(got.data_dict[0], want.data_dict[0])


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("slakh_port")
    for split, n in (("train", 3), ("validation", 2), ("test", 2)):
        make_fixture_dataset(root / split, n_tracks=n, seconds=26, sr=SR)
    return root


@pytest.mark.parametrize("kw", [dict(batch_size=4, shuffle=True, drop_last=True, seed=1),
                                dict(batch_size=4, shuffle=True, drop_last=False, seed=2),
                                dict(batch_size=4, shuffle=False, drop_last=False),
                                dict(batch_size=4, shuffle=True, drop_last=True, seed=1,
                                     num_workers=1),
                                dict(batch_size=2, shuffle=True, seed=7, process_index=1,
                                     process_count=3),
                                dict(batch_size=2, shuffle=True, drop_last=True, seed=7,
                                     process_index=0, process_count=2)])
def test_loader_batches_bit_equal_to_jax(fixture_root, kw):
    ds = SlakhDataset(str(fixture_root / "train"), **_ds_kw())
    port, jax_loader = DataLoader(ds, **kw), JaxDataLoader(ds, **kw)
    assert len(port) == len(jax_loader)
    for _ in range(2):  # two epochs: the permutation moves on alike
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == len(port)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_loader_abandoned_iterator_stops_producer(fixture_root):
    ds = SlakhDataset(str(fixture_root / "train"), **_ds_kw())
    baseline = threading.active_count()
    for _ in range(4):
        it = iter(DataLoader(ds, batch_size=2, num_workers=1))
        next(it)  # consume one batch, abandon the rest
        del it
    deadline = time.time() + 10
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= baseline


@pytest.mark.parametrize("count", [2, 3, 4])
@pytest.mark.parametrize("loader", ["train_dataloader", "predict_dataloader"])
def test_rank_shards_bit_equal_to_jax(fixture_root, monkeypatch, loader, count):
    """Rank r of N (the port's ``process_info``, JAX's ``process_info``)
    reads the JAX DataLoader's shard r of N bit for bit; unshuffled, the N
    shards cover the split."""
    import msla_tpu.parallel.mesh as jax_mesh
    import msla_tpu_torch.parallel.mesh as mesh

    seen = []
    for r in range(count):
        for module in (jax_mesh, mesh):
            monkeypatch.setattr(module, "_recorded_rank", r)
            monkeypatch.setattr(module, "_recorded_count", count)
        got = getattr(SlakhDataModule(**_dm_kw(fixture_root)), loader)()
        want = getattr(JaxSlakhDataModule(**_dm_kw(fixture_root)), loader)()
        assert (got.process_index, got.process_count) == (want.process_index,
                                                          want.process_count) == (r, count)
        got_b, want_b = list(got), list(want)
        assert len(got_b) == len(want_b) == len(got) > 0
        for a, b in zip(got_b, want_b):
            np.testing.assert_array_equal(a, b)
        seen.append(np.concatenate(got_b)[:, 0, :8])
    if loader == "predict_dataloader":   # unshuffled, nothing dropped: every frame read
        every = {got.dataset[i][0, :8].tobytes() for i in range(len(got.dataset))}
        assert {row.tobytes() for shard in seen for row in shard} == every


def _dm_kw(root):
    return dict(train_dir=str(root / "train"), val_dir=str(root / "validation"),
                test_dir=str(root / "test"), target_sample_rate=SR,
                target_sample_duration=2, max_duration=120, maximum_dataset_size=150000,
                batch_size=4, num_workers=1, masking=True, seed=3)


@pytest.mark.parametrize("loader", ["train_dataloader", "val_dataloader", "test_dataloader",
                                    "predict_dataloader"])
def test_datamodule_loaders_yield_the_jax_batches(fixture_root, loader):
    got = getattr(SlakhDataModule(**_dm_kw(fixture_root)), loader)()
    want = getattr(JaxSlakhDataModule(**_dm_kw(fixture_root)), loader)()
    assert isinstance(got, DataLoader)
    assert (got.batch_size, got.shuffle, got.drop_last, got.num_workers) == \
        (want.batch_size, want.shuffle, want.drop_last, want.num_workers)
    assert (got.process_index, got.process_count) == (0, 1)
    got_b, want_b = list(got), list(want)
    assert len(got_b) == len(want_b) == len(got) > 0
    for a, b in zip(got_b, want_b):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    index = json.loads((fixture_root / "train" / "dataset_dict.json").read_text())
    assert {"file_path_idx", "frame_start", "frame_end"} == set(index[0])
