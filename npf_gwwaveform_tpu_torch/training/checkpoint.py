"""Read and write a run's flax checkpoint with the standard library and
numpy, and map it onto and off the port's modules.

`params.msgpack` and `extra_vars.msgpack` are flax `serialization.to_bytes`
output: msgpack maps of str keys whose array leaves are msgpack extension
type 1, itself a msgpack array (shape, dtype name, raw C-order bytes). The
reader decodes that subset of msgpack and the writer encodes it byte for byte
as flax does; neither imports flax or msgpack.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

__all__ = ["read_msgpack", "write_msgpack", "load_run_params", "params_from_flax",
           "flax_from_params", "save_run_params"]

_EXT_NDARRAY = 1  # flax's msgpack extension code for an ndarray


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {  # type byte -> (length format, kind)
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), self.take(n))
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in scalars:
            return self.unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.unpack("b")
            return self.ext(code, self.take(fixext[t]))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    @staticmethod
    def ext(code: int, payload: bytes):
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, buf = _Reader(payload).obj()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_msgpack(path: str):
    """Decode a flax msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return out


def load_run_params(run_dir: str):
    """(params, extra_vars) of a frozen run; extra_vars is {} when the run
    has no `extra_vars.msgpack`."""
    params = read_msgpack(os.path.join(run_dir, "params.msgpack"))
    extra_path = os.path.join(run_dir, "extra_vars.msgpack")
    extra = read_msgpack(extra_path) if os.path.exists(extra_path) else {}
    return params, extra


# flax module path -> the port's, where they differ: DiscardIthArg's inner
# module, the ConvCNP decoder's MLP or the ConvLNP decoder's Dense
_RENAMES = {"MLP_0": "module", "Dense_0": "module"}


def _flax_name(parts: list, i: int) -> str:
    """The flax name of the port's path element parts[i]: DiscardIthArg's
    `module` is `Dense_0` where it holds the leaf itself, else `MLP_0`."""
    if parts[i] != "module":
        return parts[i]
    return "Dense_0" if i == len(parts) - 2 else "MLP_0"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(params: dict, extra_vars: dict = None) -> dict:
    """Map flax numpy trees onto a state dict of the port's modules.

    Dense `kernel [in, out]` -> `weight [out, in]`; conv `kernel [k, in/g,
    out]` -> `weight [out, in/g, k]`; BatchNorm `scale`/`bias` and the
    `batch_stats` `mean`/`var` keep their names.
    """
    extra_vars = extra_vars or {}
    unknown = set(extra_vars) - {"batch_stats"}
    if unknown:
        raise ValueError(f"unsupported variable collections: {sorted(unknown)}")
    state = {}
    for tree in (params, extra_vars.get("batch_stats", {})):
        for path, leaf in _flatten(tree):
            *mods, name = (_RENAMES.get(p, p) for p in path)
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                name = "weight"
                arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
            state[".".join(mods + [name])] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return state


def _pack_uint(n: int, codes, fix_max: int = -1, fix_base: int = 0) -> bytes:
    """A msgpack length or unsigned int: the fix form up to fix_max, else the
    8-, 16- or 32-bit form whose type byte `codes` lists (None: absent)."""
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, ("B", "H", "I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack(obj, out: list) -> None:
    if isinstance(obj, dict):
        out.append(_pack_uint(len(obj), (None, 0xDE, 0xDF), 15, 0x80))
        for k, v in sorted((str(k), v) for k, v in obj.items()):  # flax sorts the keys
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_uint(len(obj), (None, 0xDC, 0xDD), 15, 0x90))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_pack_uint(len(raw), (0xD9, 0xDA, 0xDB), 31, 0xA0) + raw)
    elif isinstance(obj, bytes):
        out.append(_pack_uint(len(obj), (0xC4, 0xC5, 0xC6)) + obj)
    elif isinstance(obj, int) and 0 <= obj < 2**64:
        out.append(bytes([obj]) if obj < 0x80 else
                   _pack_uint(obj, (0xCC, 0xCD, 0xCE)) if obj <= 0xFFFFFFFF else
                   b"\xcf" + struct.pack(">Q", obj))
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        payload: list = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], payload)
        data = b"".join(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = (bytes([fixext[len(data)]]) if len(data) in fixext
                else _pack_uint(len(data), (0xC7, 0xC8, 0xC9)))
        out.append(head + struct.pack(">b", _EXT_NDARRAY) + data)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a flax msgpack file")


def write_msgpack(path: str, tree) -> None:
    """Encode nested dicts of numpy arrays as flax `serialization.to_bytes`
    does, byte for byte (keys sorted)."""
    out: list = []
    _pack(tree, out)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def flax_from_params(state: dict, buffer_names) -> tuple:
    """The inverse of `params_from_flax`: a state dict of the port's modules
    -> (params, extra_vars) numpy trees in flax's layout; the entries named in
    `buffer_names` (BatchNorm's running `mean`/`var`) go to `batch_stats`."""
    buffer_names = set(buffer_names)
    params, stats = {}, {}
    for key, t in state.items():
        parts = key.split(".")
        *mods, name = (_flax_name(parts, i) for i in range(len(parts)))
        arr = t.detach().cpu().float().numpy()
        if name == "weight":
            name = "kernel"
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        node = stats if key in buffer_names else params
        for m in mods:
            node = node.setdefault(m, {})
        # a copy: a CPU tensor's numpy view would follow later in-place updates
        node[name] = np.array(arr, order="C", copy=True)
    return params, ({"batch_stats": stats} if stats else {})


def save_run_params(run_dir: str, model: torch.nn.Module) -> None:
    """Write `params.msgpack` and `extra_vars.msgpack` of `model` into run_dir,
    readable by `load_run_params` and by flax's `from_bytes`."""
    params, extra = flax_from_params(model.state_dict(),
                                     [n for n, _ in model.named_buffers()])
    os.makedirs(run_dir, exist_ok=True)
    write_msgpack(os.path.join(run_dir, "params.msgpack"), params)
    write_msgpack(os.path.join(run_dir, "extra_vars.msgpack"), extra)
