"""The port's msgpack decoder (msla_tpu_torch.utils.msgpack) against flax's
``serialization.msgpack_restore`` on what ``msgpack_serialize`` writes: every
ext type (ndarray, native_complex, npscalar), bf16 leaves (as
``torch.bfloat16``, the same bits), flax's chunked arrays, nested maps, every
width of int, str, bin, array and map, nil and bool, bit for bit; leaves that
are views of the file's buffer; truncated and foreign input raising."""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from msla_tpu_torch.utils import msgpack


def _tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal(7),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "i8": np.array([-128, 0, 127], np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, (4,), dtype=np.int32),
        "u16": np.array([0, 65535], np.uint16),
        "i64": np.array([[-2**62, 2**62]], np.int64),
        "bool": np.array([True, False, True]),
        "c64": (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64),
        "empty": np.zeros((0, 3), np.float32),
        "scalar0d": np.asarray(2.5, np.float32),
        "bf16": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
        "npscalar": np.float32(1.25),
        "npint": np.int64(-7),
        "complex": complex(1.5, -2.0),
        "nested": {"a": {"b": {"c": np.arange(6, dtype=np.int32).reshape(2, 3)}},
                   "list": [1, -1, -33, 200, 70000, -70000, 2**40, -2**40, 2**63 - 1],
                   "pair": [0.5, "x"], "none": None, "t": True, "f": False,
                   "float": math.pi, "str": "é" * 40, "long_str": "s" * 300,
                   "bytes": b"\x00\xff" * 20, "long_bytes": bytes(range(256)) * 300},
        "map16": {f"k{i}": i for i in range(20)},
        "array16": list(range(20)),
    }


def _equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      want.view(np.uint16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def test_decoder_matches_flax_restore():
    encoded = serialization.msgpack_serialize(_tree())
    _equal(msgpack.unpackb(encoded), serialization.msgpack_restore(encoded))


def test_chunked_arrays_are_joined(monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into a chunked dict; a
    small limit makes it split these (bf16 ones too)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((10, 7)).astype(np.float32),
            "bf16": {"w": np.asarray(rng.standard_normal((9, 5)), ml_dtypes.bfloat16)},
            "small": np.ones(3, np.float32)}
    encoded = serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(encoded)
    assert raw["big"].shape == (10, 7)
    _equal(raw, serialization.msgpack_restore(encoded))


def test_jax_arrays_and_a_file(tmp_path):
    """A tree of jax arrays written to a file, as the JAX checkpoints are."""
    tree = {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": jnp.ones(4, jnp.bfloat16), "step": 3}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    _equal(msgpack.read(path), serialization.msgpack_restore(path.read_bytes()))
    assert msgpack.is_msgpack_map(path.read_bytes()[:4])


def test_leaves_are_views_of_the_buffer():
    """No copy of an fp32 leaf: writing the buffer shows through it."""
    buf = bytearray(serialization.msgpack_serialize({"w": np.zeros(1000, np.float32)}))
    w = msgpack.unpackb(buf)["w"]
    at = buf.rfind(bytes(4000))
    buf[at:at + 4] = np.float32(3.0).tobytes()
    assert w[0] == 3.0 and w.flags.writeable


@pytest.mark.parametrize("data,match", [(b"\x81\xa1a", "truncated"),
                                        (b"\x81\xa1a\x01\x02", "after the value"),
                                        (b"\xc1", "starts no value")])
def test_bad_input_raises(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack.unpackb(data)


def test_the_format_is_told_by_its_first_bytes(tmp_path):
    torch.save({"a": torch.zeros(1)}, tmp_path / "t.pt")
    assert not msgpack.is_msgpack_map((tmp_path / "t.pt").read_bytes()[:4])
    assert not msgpack.is_msgpack_map(b"\x80")          # an empty map, or a pickle
    assert msgpack.is_msgpack_map(b"\xde\x00\x20")      # map16
