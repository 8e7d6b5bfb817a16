"""Program IR descriptions: the serializable op-graph (counterpart of
paddle_tpu/core/proto.py).

ProgramDesc > BlockDesc > {OpDesc, VarDesc} as plain dataclasses with the
JAX package's canonical JSON serialization, so a program built by either
package parses in the other (``serialize_to_string`` /
``parse_from_string``) and the two can be compared desc by desc and by
``fingerprint()``.  The enum values, the JSON layout and the fingerprint
are copies of the reference's; only the runtime dtype table differs
(torch dtypes instead of jax's).
"""

from __future__ import annotations

import copy
import hashlib
import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "VarType",
    "DataType",
    "VarDesc",
    "OpDesc",
    "BlockDesc",
    "ProgramDesc",
    "dtype_to_torch",
    "convert_dtype",
]


class VarType(IntEnum):
    """Variable kinds (reference: framework.proto:105-163 VarType.Type)."""

    LOD_TENSOR = 7          # dense tensor (+ optional LoD ragged offsets)
    SELECTED_ROWS = 8       # sparse row-set tensor (embedding grads)
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17


class DataType(IntEnum):
    """Element dtypes (reference: framework.proto:91-103 VarType.Type scalars)."""

    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    # additions of the JAX package (bfloat16 is its MXU-preferred dtype)
    UINT8 = 20
    INT8 = 21
    BF16 = 22


_NP_BY_DTYPE = {
    DataType.BOOL: np.dtype(np.bool_),
    DataType.INT16: np.dtype(np.int16),
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FP16: np.dtype(np.float16),
    DataType.FP32: np.dtype(np.float32),
    DataType.FP64: np.dtype(np.float64),
    DataType.UINT8: np.dtype(np.uint8),
    DataType.INT8: np.dtype(np.int8),
}


def dtype_to_numpy(dtype: "DataType"):
    if dtype == DataType.BF16:
        raise TypeError("bfloat16 has no numpy dtype; use dtype_to_torch")
    return _NP_BY_DTYPE[DataType(dtype)]


def dtype_to_torch(dtype: "DataType"):
    """The torch dtype a value of this desc dtype has at run time (64-bit
    widths are kept: torch has no x64 switch to narrow them)."""
    import torch

    return {
        DataType.BOOL: torch.bool, DataType.INT16: torch.int16,
        DataType.INT32: torch.int32, DataType.INT64: torch.int64,
        DataType.FP16: torch.float16, DataType.FP32: torch.float32,
        DataType.FP64: torch.float64, DataType.UINT8: torch.uint8,
        DataType.INT8: torch.int8, DataType.BF16: torch.bfloat16,
    }[DataType(dtype)]


def numpy_to_dtype(np_dtype) -> "DataType":
    name = np.dtype(np_dtype).name if not _is_bf16(np_dtype) else "bfloat16"
    table = {
        "bool": DataType.BOOL,
        "int16": DataType.INT16,
        "int32": DataType.INT32,
        "int64": DataType.INT64,
        "float16": DataType.FP16,
        "float32": DataType.FP32,
        "float64": DataType.FP64,
        "uint8": DataType.UINT8,
        "int8": DataType.INT8,
        "bfloat16": DataType.BF16,
    }
    if name not in table:
        raise ValueError(f"unsupported numpy dtype {np_dtype!r}")
    return table[name]


def _is_bf16(np_dtype) -> bool:
    try:
        return np.dtype(np_dtype).name == "bfloat16"
    except TypeError:
        return "bfloat16" in str(np_dtype)


def convert_dtype(dtype) -> "DataType":
    """Coerce user-supplied dtype (string / numpy / DataType) to DataType."""
    if isinstance(dtype, DataType):
        return dtype
    if isinstance(dtype, str):
        aliases = {
            "float": "float32",
            "double": "float64",
            "half": "float16",
            "int": "int32",
            "long": "int64",
            "bf16": "bfloat16",
        }
        dtype = aliases.get(dtype, dtype)
        if dtype == "bfloat16":
            return DataType.BF16
        return numpy_to_dtype(np.dtype(dtype))
    return numpy_to_dtype(dtype)


@dataclass
class VarDesc:
    """Description of one variable (reference: framework.proto:165-180 VarDesc)."""

    name: str
    type: VarType = VarType.LOD_TENSOR
    shape: List[int] = field(default_factory=list)  # -1 = dynamic (batch) dim
    dtype: DataType = DataType.FP32
    lod_level: int = 0
    persistable: bool = False
    stop_gradient: bool = False
    # logical sharding spec, one entry per axis — mesh-axis name(s) or
    # None.  Kept in the desc (and the fingerprint); the port's single-card
    # executor does not act on it.
    sharding: Optional[List[Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": int(self.type),
            "shape": list(self.shape),
            "dtype": int(self.dtype),
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "sharding": self.sharding,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VarDesc":
        return VarDesc(
            name=d["name"],
            type=VarType(d.get("type", VarType.LOD_TENSOR)),
            shape=list(d.get("shape", [])),
            dtype=DataType(d.get("dtype", DataType.FP32)),
            lod_level=d.get("lod_level", 0),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            sharding=d.get("sharding"),
        )


@dataclass
class OpDesc:
    """Description of one operator (reference: framework.proto:43-57 OpDesc).

    inputs/outputs map *slot names* (e.g. "X", "Out") to lists of variable
    names.  attrs hold plain JSON-able Python values; sub-blocks are referenced
    by integer block index under attr name "sub_block" (reference:
    framework.proto:56 block_idx).
    """

    type: str
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for names in self.inputs.values() for n in names]

    def output_arg_names(self) -> List[str]:
        return [n for names in self.outputs.values() for n in names]

    def attr(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpDesc":
        return OpDesc(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs=_attrs_from_jsonable(d.get("attrs", {})),
        )


def _jsonable_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _attrs_from_jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


@dataclass
class BlockDesc:
    """One block: an ordered op list plus the vars they reference
    (reference: framework.proto:171-180 BlockDesc)."""

    idx: int = 0
    parent_idx: int = -1
    vars: Dict[str, VarDesc] = field(default_factory=dict)
    ops: List[OpDesc] = field(default_factory=list)
    # Index of the forward block this block holds gradients for (-1 = none);
    # mirrors the reference's forward_block_idx (framework.proto:178).
    forward_block_idx: int = -1

    def var(self, name: str) -> VarDesc:
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BlockDesc":
        return BlockDesc(
            idx=d["idx"],
            parent_idx=d.get("parent_idx", -1),
            forward_block_idx=d.get("forward_block_idx", -1),
            vars={k: VarDesc.from_dict(v) for k, v in d.get("vars", {}).items()},
            ops=[OpDesc.from_dict(o) for o in d.get("ops", [])],
        )


@dataclass
class ProgramDesc:
    """Whole program: block 0 is global; sub-blocks hold control-flow bodies
    (reference: framework.proto:184-188 ProgramDesc)."""

    blocks: List[BlockDesc] = field(default_factory=lambda: [BlockDesc(idx=0)])
    version: int = 1
    # bumped by framework-layer mutators for in-place edits that don't change
    # op/var counts (attr edits, transpiler rewrites); lets fingerprint() memoize
    _mod_count: int = field(default=0, repr=False, compare=False)

    def bump(self) -> None:
        """Record an in-place mutation (invalidates the fingerprint memo)."""
        self._mod_count += 1

    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    def num_blocks(self) -> int:
        return len(self.blocks)

    def append_block(self, parent_idx: int) -> BlockDesc:
        b = BlockDesc(idx=len(self.blocks), parent_idx=parent_idx)
        self.blocks.append(b)
        return b

    def clone(self) -> "ProgramDesc":
        return copy.deepcopy(self)

    def fingerprint(self) -> bytes:
        """Content hash over every block's ops and var descs (a copy of
        the JAX package's, so equal descs hash equal across the two).

        Memoized on (mod-count, per-block op/var counts): recomputed only
        when the program grows or a mutator called bump().  Direct raw-desc
        edits must call bump() themselves."""
        memo_key = (
            self._mod_count,
            tuple((len(b.ops), len(b.vars)) for b in self.blocks),
        )
        cached = getattr(self, "_fp_cache", None)
        if cached is not None and cached[0] == memo_key:
            return cached[1]
        h = hashlib.blake2b(digest_size=16)
        for b in self.blocks:
            h.update(b"B%d,%d" % (b.idx, b.forward_block_idx))
            for op in b.ops:
                h.update(op.type.encode())
                h.update(repr(sorted(op.inputs.items())).encode())
                h.update(repr(sorted(op.outputs.items())).encode())
                h.update(
                    repr(sorted((k, repr(v)) for k, v in op.attrs.items())).encode()
                )
            for name in sorted(b.vars):
                v = b.vars[name]
                h.update(
                    repr((name, int(v.type), v.shape, int(v.dtype), v.lod_level,
                          v.persistable, v.sharding)).encode()
                )
        digest = h.digest()
        self._fp_cache = (memo_key, digest)
        return digest

    # -- serde ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.to_dict(), separators=(",", ":")).encode("utf-8")

    @staticmethod
    def parse_from_string(data: bytes) -> "ProgramDesc":
        d = json.loads(data.decode("utf-8"))
        return ProgramDesc.from_dict(d)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ProgramDesc":
        return ProgramDesc(
            version=d.get("version", 1),
            blocks=[BlockDesc.from_dict(b) for b in d.get("blocks", [])],
        )
