"""Checkpoint files: the port of paddle_tpu/framework/io.py's
``paddle.save`` / ``paddle.load``, in the reference's own format, so that
files cross both ways.

The format is a pickle (protocol 4) of nested dicts, lists and tuples.
A tensor leaf is the reference's ``_TensorPayload``: ``dtype_name``,
``raw`` (a numpy array; bf16 as its uint16 bits) and ``shape``. numpy
arrays (an optimizer's state: bf16 as ``ml_dtypes.bfloat16`` arrays),
numbers and strings are stored as they are. A write is crash-safe: the
whole pickle goes to a temporary file beside the target, is fsynced and
then renamed over it, so a reader sees the old file or the new one.

Neither direction imports the JAX package or ``ml_dtypes``:

* `load` unpickles through `_Unpickler.find_class`, which maps the
  reference's payload class to `TensorPayload`, ``ml_dtypes.bfloat16`` to
  a 2-byte stand-in, and ``numpy._core`` / ``numpy.core`` (numpy 2 and
  1 spell the array's rebuild function so) to the same rebuild; a
  pickled JAX array (the reference's step count can be one) is read as
  its numpy array. Any other global is refused. Payloads become torch
  tensors, bf16 arrays bf16 tensors, other numpy arrays stay numpy
  (``return_numpy=True``: every tensor a numpy array, bf16 as a
  `Bfloat16Bits` view of its bits).
* `save` turns torch tensors into payloads and writes, through its own
  pickler, the reference's payload class and ``ml_dtypes.bfloat16`` by
  name (pickle would otherwise look the names up, and the port must not
  import those modules). A `Bfloat16Bits` array is written as the
  reference's ``ml_dtypes.bfloat16`` array.
"""
from __future__ import annotations

import codecs
import collections
import io
import os
import pickle

import numpy as np
import torch

__all__ = ["Bfloat16Bits", "TensorPayload", "load", "save"]

_REFERENCE_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")
_ML_DTYPES_BF16 = ("ml_dtypes", "bfloat16")
# numpy's pickled dtype state of ml_dtypes.bfloat16: version 3,
# little-endian, no subarray, names or fields, itemsize 2, alignment 2,
# flags 64 (NPY_USE_GETITEM)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)
# numpy's array rebuild function, under the module path of the numpy
# that writes (numpy._core.multiarray in numpy 2, numpy.core in numpy 1)
_RECONSTRUCT = np.empty(0).__reduce__()[0]
_NUMPY_CORE = ("numpy._core.multiarray", "numpy.core.multiarray")
# how a JAX array pickles (an optimizer's step count in a reference file):
# read as the numpy array it holds
_JAX_ARRAY = ("jax._src.array", "_reconstruct_array")


class Bfloat16Bits(np.ndarray):
    """uint16 numpy array of the bit patterns of bf16 values: how bf16
    crosses numpy without ``ml_dtypes`` (``arr.view(Bfloat16Bits)``;
    `torch_bfloat16` gives the tensor). A carrier only: arithmetic on it
    is uint16 arithmetic."""

    def __new__(cls, bits):
        return np.array(bits, np.uint16, order="C").view(cls)

    def torch_bfloat16(self) -> torch.Tensor:
        bits = np.array(self, np.uint16, order="C")
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


class TensorPayload:
    """The reference's ``_TensorPayload``: ``dtype_name``, ``raw`` (bf16
    as uint16) and ``shape``."""

    def __init__(self, tensor: torch.Tensor):
        t = tensor.detach().cpu().contiguous()
        self.dtype_name = str(t.dtype).removeprefix("torch.")
        self.raw = (t.view(torch.int16).numpy().view(np.uint16)
                    if t.dtype == torch.bfloat16 else t.numpy())
        self.shape = tuple(t.shape)

    def to_torch(self) -> torch.Tensor:
        raw = np.array(self.raw, order="C")
        if self.dtype_name == "bfloat16":
            return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(raw)

    def to_numpy(self) -> np.ndarray:
        if self.dtype_name == "bfloat16":
            return Bfloat16Bits(self.raw)
        return self.raw


# -- load ------------------------------------------------------------------

class _Bfloat16Scalar:
    """Stands for ``ml_dtypes.bfloat16`` in a stream: the scalar type a
    bf16 array's dtype is rebuilt from."""


class _Bfloat16Dtype:
    """``numpy.dtype(ml_dtypes.bfloat16)``: what it rebuilds to on load,
    and what `_Pickler` writes it from."""

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=True):
    if obj is _Bfloat16Scalar:
        return _Bfloat16Dtype()
    return np.dtype(obj, align, copy)


class _ArrayStub:
    """A numpy array being unpickled: the rebuild function makes it, the
    array's state arrives in ``__setstate__`` (``value`` after)."""

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _Bfloat16Dtype):
            self.value = Bfloat16Bits(
                np.frombuffer(raw, np.uint16).reshape(shape))
            return
        if dtype.hasobject:
            raise pickle.UnpicklingError(
                "an object array: not a checkpoint leaf")
        self.value = np.frombuffer(raw, dtype).reshape(
            shape, order="F" if fortran else "C").copy()


def _reconstruct(cls, shape, typecode):
    return _ArrayStub()


def _jax_array(fun, args, arr_state, aval_state):
    """A pickled JAX array (the reference's step count): numpy's rebuild
    and state, and the abstract value's, which a numpy array drops."""
    stub = fun(*args)
    stub.__setstate__(arr_state)
    return stub


def _scalar(dtype, raw):
    return np.frombuffer(raw, dtype)[0]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _REFERENCE_PAYLOAD:
            return TensorPayload
        if (module, name) == _ML_DTYPES_BF16:
            return _Bfloat16Scalar
        if module in _NUMPY_CORE and name == "_reconstruct":
            return _reconstruct
        if module in _NUMPY_CORE and name == "scalar":
            return _scalar
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if (module, name) == ("numpy", "ndarray"):
            return np.ndarray
        if (module, name) == _JAX_ARRAY:
            return _jax_array
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        if (module, name) == ("_codecs", "encode"):
            return codecs.encode       # bytes below protocol 3
        raise pickle.UnpicklingError(
            f"{module}.{name}: not a global that a checkpoint file holds")


def _unpack(obj, return_numpy):
    if isinstance(obj, _ArrayStub):
        obj = obj.value
    if isinstance(obj, TensorPayload):
        obj.raw = _unpack(obj.raw, True)
        return obj.to_numpy() if return_numpy else obj.to_torch()
    if isinstance(obj, Bfloat16Bits):
        return obj if return_numpy else obj.torch_bfloat16()
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_unpack(v, return_numpy) for v in obj]
        return tuple(vals) if isinstance(obj, tuple) else vals
    return obj


def load(path, return_numpy=False, **configs):
    """Read a file `save` or the reference's ``paddle.save`` wrote:
    tensors come back as torch CPU tensors (numpy arrays with
    ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy)


# -- save ------------------------------------------------------------------

# objects written as the reference's globals, by name
_ALIASES = {TensorPayload: _REFERENCE_PAYLOAD,
            _Bfloat16Scalar: _ML_DTYPES_BF16}


class _Pickler(pickle._Pickler):
    """The Python pickler, writing `_ALIASES` under the reference's names
    and `Bfloat16Bits` arrays as ``ml_dtypes.bfloat16`` arrays."""

    def save_global(self, obj, name=None):
        alias = _ALIASES.get(obj) if isinstance(obj, type) else None
        if alias is None:
            return super().save_global(obj, name)
        module, qualname = alias
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)

    def reducer_override(self, obj):
        if isinstance(obj, Bfloat16Bits):
            bits = np.array(obj, np.uint16, order="C")
            return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, bits.shape, _Bfloat16Dtype(), False,
                     bits.tobytes()))
        if isinstance(obj, _Bfloat16Dtype):
            return (np.dtype, (_Bfloat16Scalar, False, True),
                    _BF16_DTYPE_STATE)
        return NotImplemented


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return tuple(packed) if isinstance(obj, tuple) else packed
    return obj


def save(obj, path, protocol=4, **configs):
    """Write ``obj`` (nested dicts, lists and tuples of tensors, numpy
    arrays, numbers and strings) in the reference's format, crash-safe."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(_pack(obj))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getbuffer())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
