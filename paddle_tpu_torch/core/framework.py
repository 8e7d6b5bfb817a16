"""Graph-building front end: Program / Block / Operator / Variable
(counterpart of paddle_tpu/core/framework.py).

Python code builds *descriptions only*; tensors exist when the executor
runs a block (core/compiler.py).  As in the JAX package, shape and dtype
inference run when an op is appended (``Operator.__init__`` calls the
registered ``infer_shape``), and names come from the same counters, so
the same layer calls give the same desc in both packages.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

from .proto import (BlockDesc, DataType, OpDesc, ProgramDesc, VarDesc,
                    VarType, convert_dtype)
from .registry import GRAD_SUFFIX, OpRegistry

__all__ = [
    "Block", "Operator", "Parameter", "Program", "Variable",
    "default_main_program", "default_startup_program", "grad_var_name",
    "program_guard", "switch_main_program", "switch_startup_program",
    "unique_name", "unique_name_guard",
]


# ---------------------------------------------------------------------------
# unique names (the counters behind every generated var and param name)
# ---------------------------------------------------------------------------
class _UniqueNameGenerator:
    """A prefix plus one counter per key: key_0, key_1, ..."""

    def __init__(self, prefix: str = ""):
        self.ids = defaultdict(int)
        self.prefix = prefix or ""

    def __call__(self, key: str) -> str:
        name = f"{self.prefix}{key}_{self.ids[key]}"
        self.ids[key] += 1
        return name


_name_generator = _UniqueNameGenerator()


def unique_name(key: str) -> str:
    return _name_generator(key)


def unique_name_switch(new_generator=None):
    """Swap the global name generator, returning the old one."""
    global _name_generator
    old = _name_generator
    _name_generator = (new_generator if new_generator is not None
                       else _UniqueNameGenerator())
    return old


@contextlib.contextmanager
def unique_name_guard(new_generator=None):
    """Fresh name counters inside the context (a str argument becomes the
    prefix of every generated name): two programs built under separate
    guards get identical auto-generated names."""
    if isinstance(new_generator, (str, bytes)):
        prefix = (new_generator.decode()
                  if isinstance(new_generator, bytes) else new_generator)
        new_generator = _UniqueNameGenerator(prefix)
    saved = unique_name_switch(new_generator)
    try:
        yield
    finally:
        unique_name_switch(saved)


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """Symbolic tensor in a block: a wrapper over its VarDesc."""

    def __init__(self, block: "Block", name: Optional[str] = None,
                 shape: Optional[Sequence[int]] = None, dtype: Any = None,
                 lod_level: Optional[int] = None,
                 persistable: Optional[bool] = None,
                 stop_gradient: bool = False,
                 type: VarType = VarType.LOD_TENSOR,
                 sharding: Optional[Sequence[Any]] = None):
        self.block = block
        if name is None:
            name = unique_name("_generated_var")
        if block.desc.has_var(name):
            # re-wrap an existing desc
            desc = block.desc.var(name)
            if shape is not None and list(shape) != list(desc.shape):
                desc.shape = list(shape)
            if dtype is not None:
                desc.dtype = convert_dtype(dtype)
        else:
            desc = VarDesc(
                name=name, type=type,
                shape=list(shape) if shape is not None else [],
                dtype=(convert_dtype(dtype) if dtype is not None
                       else DataType.FP32),
                lod_level=lod_level or 0, persistable=bool(persistable),
                stop_gradient=stop_gradient,
                sharding=list(sharding) if sharding is not None else None)
            block.desc.vars[name] = desc
        self.desc = desc
        block.vars[name] = self

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self) -> tuple:
        return tuple(self.desc.shape)

    @shape.setter
    def shape(self, value):
        self.desc.shape = list(value)

    @property
    def dtype(self) -> DataType:
        return self.desc.dtype

    @dtype.setter
    def dtype(self, value):
        self.desc.dtype = convert_dtype(value)

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, value: bool):
        self.desc.persistable = bool(value)

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.desc.stop_gradient = bool(value)

    @property
    def type(self) -> VarType:
        return self.desc.type

    @property
    def sharding(self):
        return self.desc.sharding

    @sharding.setter
    def sharding(self, spec):
        self.desc.sharding = list(spec) if spec is not None else None

    def __repr__(self) -> str:
        return (f"var {self.name} : {VarType(self.type).name} "
                f"shape={list(self.shape)} dtype={DataType(self.dtype).name}"
                f"{' persistable' if self.persistable else ''}")


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


class Operator:
    """One op in a block: appends its OpDesc's slots and attrs and runs
    the registered compile-time infer_shape to fill its output descs."""

    def __init__(self, block: "Block", desc: OpDesc,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None, infer: bool = True):
        self.block = block
        self.desc = desc
        if inputs:
            desc.inputs = {k: _var_name_list(v) for k, v in inputs.items()
                           if v is not None}
        if outputs:
            desc.outputs = {k: _var_name_list(v) for k, v in outputs.items()
                            if v is not None}
        if attrs:
            desc.attrs.update({k: v for k, v in attrs.items()
                               if v is not None})
        if infer and OpRegistry.has(desc.type):
            info = OpRegistry.get(desc.type)
            if info.infer_shape is not None:
                info.infer_shape(desc, block)

    @property
    def type(self) -> str:
        return self.desc.type

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in sorted(self.desc.inputs.items()))
        outs = ", ".join(f"{k}={v}"
                         for k, v in sorted(self.desc.outputs.items()))
        return f"{{{outs}}} = {self.type}({ins})"


def _var_name_list(v) -> List[str]:
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Block:
    """Ordered op list + var map."""

    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.desc: BlockDesc = program.desc.block(idx)
        self.vars: Dict[str, Variable] = {}
        # wrappers for descs that already carry ops (a parsed program)
        self.ops: List[Operator] = [Operator(self, d, infer=False)
                                    for d in self.desc.ops]

    @property
    def idx(self) -> int:
        return self.desc.idx

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        return Variable(self, **kwargs)

    def create_parameter(self, **kwargs) -> Parameter:
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype")
        # parameters always live in the global block
        return Parameter(self.program.global_block(), shape, dtype, **kwargs)

    def has_var(self, name: str) -> bool:
        return self.desc.has_var(name)

    def var(self, name: str) -> Variable:
        v = self._find_var_local(name)
        if v is None:
            raise ValueError(f"variable '{name}' not found in block {self.idx}")
        return v

    def _find_var_local(self, name: str) -> Optional[Variable]:
        if name in self.vars:
            return self.vars[name]
        if self.desc.has_var(name):
            return Variable(self, name=name)
        return None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            v = b._find_var_local(name)
            if v is not None:
                return v
            b = b.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs: Optional[Dict[str, Any]] = None,
                  outputs: Optional[Dict[str, Any]] = None,
                  attrs: Optional[Dict[str, Any]] = None) -> Operator:
        desc = OpDesc(type=type)
        self.desc.ops.append(desc)
        op = Operator(self, desc, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        return op


class Program:
    """A whole computation description."""

    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0

    @staticmethod
    def parse_from_string(data: bytes) -> "Program":
        """A Program over a serialized desc (either package's)."""
        p = Program()
        p.desc = ProgramDesc.parse_from_string(data)
        p.blocks = [Block(p, i) for i in range(p.desc.num_blocks())]
        return p

    @property
    def random_seed(self) -> int:
        return self._seed

    @random_seed.setter
    def random_seed(self, seed: int):
        self._seed = seed

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def num_blocks(self) -> int:
        return len(self.blocks)

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for block in self.blocks:
            for name in block.desc.vars:
                yield block.var(name)

    def __repr__(self):
        return (f"<Program blocks={self.num_blocks()} "
                f"ops={len(self.global_block().ops)}>")


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
