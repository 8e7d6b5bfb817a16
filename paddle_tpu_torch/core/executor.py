"""Executor: run a Program on a Place (counterpart of
paddle_tpu/core/executor.py).

``Executor.run`` reads the persistable state a block touches from the
scope (moving it onto the executor's device), runs the block eagerly
(core/compiler.py) with the feeds, writes the updated persistables back
and returns the fetches.  Random ops draw from a ``torch.Generator`` kept
in the scope and seeded from ``Program.random_seed`` at first use, as the
JAX executor keeps its PRNG key there.

``Executor()`` runs on the card and raises without one; ``CPUPlace()``
asks for the host, where every kernel wrapper takes its plain version.
Not ported: ``run_steps``, buffer donation, py_reader feeds, LoD feeds.
AMP is the process-wide policy of ``core/amp.py``, read by the op rules.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Set

import numpy as np
import torch

from .compiler import LoweringContext, run_block
from .framework import Program, Variable, default_main_program
from .place import CUDAPlace, Place
from .proto import VarType, dtype_to_torch
from .scope import Scope, global_scope

__all__ = ["Executor", "RNG_STATE_VAR"]

RNG_STATE_VAR = "@rng_key@"


def _state_names(program: Program, extra: Sequence[str] = ()) -> List[str]:
    """All persistable vars block 0 touches (plus fetched ones)."""
    block = program.desc.block(0)
    referenced: Set[str] = set(extra)
    for op in block.ops:
        referenced.update(op.input_arg_names())
        referenced.update(op.output_arg_names())
    return sorted(name for name, var in block.vars.items()
                  if var.persistable and name in referenced)


def _read_before_write(program: Program, state_names: Sequence[str],
                       feed_names) -> Set[str]:
    written: Set[str] = set(feed_names)
    rbw: Set[str] = set()
    states = set(state_names)
    for op in program.desc.block(0).ops:
        rbw.update(n for n in op.input_arg_names()
                   if n in states and n not in written)
        written.update(op.output_arg_names())
    return rbw


class Executor:
    """Serial single-device executor."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()  # raises without a card

    def _to_device(self, value, dtype=None) -> torch.Tensor:
        # a host array is copied: it may be read-only (a jax array's view)
        t = (value if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.array(value)))
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return t.to(self.device)

    def load_state(self, arrays: Mapping[str, Any],
                   scope: Optional[Scope] = None) -> None:
        """Put each ``{name: array}`` (numpy or tensor) into the scope on
        this executor's device — the way to start from another run's
        persistables (parameters, optimizer accumulators, the learning
        rate)."""
        scope = scope or global_scope()
        for name, value in arrays.items():
            scope.set_var(name, self._to_device(value))

    def _generator(self, scope: Scope, program: Program) -> torch.Generator:
        gen = scope.find_var(RNG_STATE_VAR)
        if not isinstance(gen, torch.Generator) or gen.device != self.device:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(program.random_seed or 0)
            scope.set_var(RNG_STATE_VAR, gen)
        return gen

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True) -> List[Any]:
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.desc.block(0)

        env: Dict[str, Any] = {}
        state_names = _state_names(program, fetch_names)
        rbw = _read_before_write(program, state_names, feed)
        for name in state_names:
            value = scope.find_var(name)
            if value is None:
                if name in rbw:
                    raise RuntimeError(
                        f"persistable variable '{name}' is read before it is "
                        "written but is not initialized in the scope; run "
                        "the startup program first")
                continue
            env[name] = self._to_device(value,
                                        dtype_to_torch(block.vars[name].dtype))
        for name, value in feed.items():
            vd = block.vars.get(name)
            dtype = (dtype_to_torch(vd.dtype)
                     if vd is not None and vd.type == VarType.LOD_TENSOR
                     else None)
            env[name] = self._to_device(value, dtype)

        ctx = LoweringContext(env, self.device,
                              self._generator(scope, program))
        run_block(ctx, block.ops, keep=state_names + fetch_names)

        for name in state_names:
            if name in env:
                scope.set_var(name, env[name])
        fetches = [ctx.lookup(n) for n in fetch_names]
        if not return_numpy:
            return fetches
        # host arrays come back in the declared dtype, as the JAX
        # executor's fetches do (an amp keep_output activation is bf16 at
        # run time, fp32 in its desc; numpy has no bfloat16)
        out = []
        for name, t in zip(fetch_names, fetches):
            vd = block.vars.get(name)
            if vd is not None and vd.type == VarType.LOD_TENSOR:
                t = t.to(dtype_to_torch(vd.dtype))
            out.append(np.asarray(t.detach().cpu()))
        return out
