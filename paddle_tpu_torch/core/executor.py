"""Executor: run a Program on a Place (counterpart of
paddle_tpu/core/executor.py).

``Executor.run`` reads the persistable state a block touches from the
scope (moving it onto the executor's device), runs the block eagerly
(core/compiler.py) with the feeds, writes the updated persistables back
and returns the fetches.  Random ops draw from a ``torch.Generator`` kept
in the scope and seeded from ``Program.random_seed`` at first use, as the
JAX executor keeps its PRNG key there.

``Executor.run_steps`` runs K steps a call, as the JAX executor's does:
step i feeds ``feed_list[i % len(feed_list)]``, every persistable the
block touches is carried from step to step, the random stream advances as
K calls of ``run`` advance it, and the last step's fetches come back.  On
``CPUPlace()`` it runs the block K times, eagerly.  On the card it
captures and replays a ``torch.cuda.CUDAGraph`` (:class:`_StepGraph`):
``mode="scan"`` captures one step and replays it K times, ``mode="flat"``
captures K chained steps and replays them once (the counterparts of
``lax.scan`` and of JAX's Python-unrolled chain).  There is no eager
fallback on the card: a capture or replay that fails raises.

``Executor()`` runs on the card and raises without one; ``CPUPlace()``
asks for the host, where every kernel wrapper takes its plain version.
Not ported: buffer donation, py_reader feeds, LoD feeds.
AMP is the process-wide policy of ``core/amp.py``, read by the op rules.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set

import numpy as np
import torch

from . import amp
from ..kernels import counters
from .compiler import LoweringContext, run_block
from .framework import Program, Variable, default_main_program
from .place import CUDAPlace, Place
from .proto import VarType, dtype_to_torch
from .scope import Scope, global_scope
from .selected_rows import SelectedRowsValue

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


def _fetch_names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]


class _RunPlan:
    """Per-(program, feeds, fetches) bookkeeping (the JAX executor's
    ``_RunPlan``): the persistables a step carries, those the scope must
    already hold, and the dtype each feed and state takes on the device."""

    def __init__(self, program: Program, feed_names, fetch_names):
        self.block = program.desc.block(0)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.state_names = _state_names(program, self.fetch_names)
        self.rbw = _read_before_write(program, self.state_names,
                                      self.feed_names)

    def state_dtype(self, name: str) -> torch.dtype:
        return dtype_to_torch(self.block.vars[name].dtype)

    def feed_dtype(self, name: str) -> Optional[torch.dtype]:
        vd = self.block.vars.get(name)
        return (dtype_to_torch(vd.dtype)
                if vd is not None and vd.type == VarType.LOD_TENSOR else None)


class Executor:
    """Serial single-device executor."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()  # raises without a card
        # constants an op builds once (assign_value's), reused by every run
        # and by a captured graph
        self._constants: Dict[Any, torch.Tensor] = {}
        # run_steps's captured graphs, by program, steps, feeds and scope
        self._graphs: Dict[tuple, _StepGraph] = {}
        # the last capture's cost: {"warmup_s", "capture_s"}
        self.last_capture: Optional[Dict[str, float]] = None

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

    def _read_state(self, plan: _RunPlan, scope: Scope) -> Dict[str, Any]:
        env: Dict[str, Any] = {}
        for name in plan.state_names:
            value = scope.find_var(name)
            if value is None:
                if name in plan.rbw:
                    raise RuntimeError(
                        f"persistable variable '{name}' is read before it is "
                        "written but is not initialized in the scope; run "
                        "the startup program first")
                continue
            env[name] = self._to_device(value, plan.state_dtype(name))
        return env

    def _feeds(self, plan: _RunPlan, feed: Mapping[str, Any]):
        return {name: self._to_device(feed[name], plan.feed_dtype(name))
                for name in plan.feed_names}

    def _step(self, plan: _RunPlan, env: Dict[str, Any],
              generator: torch.Generator) -> List[Any]:
        """Run block 0 once on ``env`` (updated in place); the fetches."""
        ctx = LoweringContext(env, self.device, generator, self._constants)
        run_block(ctx, plan.block.ops,
                  keep=plan.state_names + plan.fetch_names)
        return [ctx.lookup(n) for n in plan.fetch_names]

    def _run_once(self, plan: _RunPlan, feed, scope: Scope,
                  generator: torch.Generator) -> List[Any]:
        env = self._read_state(plan, scope)
        env.update(self._feeds(plan, feed))
        fetches = self._step(plan, env, generator)
        for name in plan.state_names:
            if name in env:
                scope.set_var(name, env[name])
        return fetches

    def _fetch_values(self, plan: _RunPlan, fetches,
                      return_numpy: bool) -> List[Any]:
        if not return_numpy:
            return fetches
        # host arrays come back in the declared dtype, as the JAX
        # executor's fetches do (an amp keep_output activation is bf16 at
        # run time, fp32 in its desc; numpy has no bfloat16)
        out = []
        for name, t in zip(plan.fetch_names, fetches):
            if isinstance(t, SelectedRowsValue):  # a sparse gradient
                out.append(t.to_numpy())
                continue
            vd = plan.block.vars.get(name)
            if vd is not None and vd.type == VarType.LOD_TENSOR:
                t = t.to(dtype_to_torch(vd.dtype))
            out.append(np.asarray(t.detach().cpu()))
        return out

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True) -> List[Any]:
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        plan = _RunPlan(program, list(feed), _fetch_names(fetch_list))
        fetches = self._run_once(plan, feed, scope,
                                 self._generator(scope, program))
        return self._fetch_values(plan, fetches, return_numpy)

    def run_steps(self, program: Optional[Program] = None,
                  feed_list: Optional[Sequence[Dict[str, Any]]] = None,
                  fetch_list: Optional[Sequence] = None,
                  steps: Optional[int] = None,
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True,
                  mode: str = "scan") -> List[Any]:
        """Run ``steps`` steps (default ``len(feed_list)``), step i on
        ``feed_list[i % len(feed_list)]``; returns the last step's
        fetches.  Every feed dict names the same variables at the same
        shapes (a ValueError before any step otherwise).  On the card
        the step is captured into a CUDA graph (``mode`` "scan": one step
        replayed ``steps`` times; "flat": ``steps`` chained steps replayed
        once), cached by program, steps, feeds, fetches, mode, AMP state
        and scope, and captured again when the program's fingerprint
        changes."""
        program = program or default_main_program()
        if not feed_list:
            raise ValueError("run_steps requires a non-empty feed_list")
        steps = int(steps if steps is not None else len(feed_list))
        if steps < 1:
            raise ValueError("run_steps requires steps >= 1")
        scope = scope or global_scope()
        feed_names = sorted(feed_list[0])
        shapes = {n: tuple(np.shape(feed_list[0][n])) for n in feed_names}
        for i, feed in enumerate(feed_list):
            if sorted(feed) != feed_names:
                raise ValueError(
                    f"run_steps feed_list[{i}] keys {sorted(feed)} differ "
                    f"from feed_list[0] keys {feed_names}; every step must "
                    "feed the same variables")
            for n in feed_names:
                if tuple(np.shape(feed[n])) != shapes[n]:
                    raise ValueError(
                        f"run_steps feed_list[{i}]['{n}'] has shape "
                        f"{tuple(np.shape(feed[n]))}, feed_list[0]'s "
                        f"{shapes[n]}; every step must feed the same shapes")
        if mode not in ("scan", "flat"):
            raise ValueError(f"run_steps mode must be 'scan' or 'flat', "
                             f"got {mode!r}")
        plan = _RunPlan(program, feed_names, _fetch_names(fetch_list))
        gen = self._generator(scope, program)
        if self.device.type == "cpu":
            for i in range(steps):
                fetches = self._run_once(plan, feed_list[i % len(feed_list)],
                                         scope, gen)
            return self._fetch_values(plan, fetches, return_numpy)
        # numpy feeds cross to the card here, never inside a capture
        staged = [self._feeds(plan, feed)
                  for feed in feed_list[:min(len(feed_list), steps)]]
        key = (id(program), steps, len(feed_list), tuple(plan.feed_names),
               tuple(plan.fetch_names), amp.state_key(), mode, id(scope),
               tuple((tuple(t.shape), t.dtype)
                     for feed in staged for t in feed.values()))
        graph = self._graphs.get(key)
        if graph is not None and not graph.serves(program, scope, gen):
            del self._graphs[key]  # free its pool before capturing again
            graph = None
        if graph is None:
            graph = _StepGraph(self, program, plan, staged, steps, mode,
                               scope, gen)
            self._graphs[key] = graph
        fetches = graph.run(self, staged, scope)
        if not return_numpy:  # the next replay writes the static outputs
            return [t.clone() for t in fetches]
        return self._fetch_values(plan, fetches, return_numpy)


class _StepGraph:
    """One captured ``run_steps`` program on the card.

    The graph reads the persistable state from static buffers
    (``states``, one per state) and ends by copying each new value into
    its buffer, so that one replay feeds the next; it reads its feeds
    from static buffers too (one set per feed the chain reads), which
    are filled from the caller's feeds before each replay.  A state the
    scope holds in another tensor (an eager ``run`` in between, another
    run's state) is copied in before the first replay, and after the call
    the scope holds the buffers.

    Capture follows one eager warm-up step on the capture stream, which
    builds and loads the kernels' libraries and initialises cuBLAS and
    autograd.  It runs on the buffers and is undone: the generator is
    reset, the counters take its launches back, and the buffers are
    filled from the scope again before the first replay.  The scope's
    generator is registered with the graph, so replay i draws what eager
    step i would.  The kernel wrappers count once, at capture; the
    counters are then set back and each replay adds the capture's counts
    (``kernels/counters.py``)."""

    def __init__(self, exe: Executor, program: Program, plan: _RunPlan,
                 staged, steps: int, mode: str, scope: Scope,
                 gen: torch.Generator):
        # no reference back to exe: dropping the executor frees its graphs
        # at once, not at a later cyclic collection (which may fall inside
        # another capture, where destroying a graph is not permitted)
        self.plan, self.gen, self.scope = plan, gen, scope
        self.fingerprint = program.desc.fingerprint()
        self.chain = steps if mode == "flat" else 1
        self.replays = 1 if mode == "flat" else steps
        self.feeds = [{n: t.clone() for n, t in feed.items()}
                      for feed in staged[:self.chain]]
        self.states = {n: t.clone()
                       for n, t in exe._read_state(plan, scope).items()}
        dev = exe.device
        stream = torch.cuda.Stream(dev)
        t0 = time.perf_counter()
        rng, before = gen.get_state(), counters.snapshot()
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._steps(exe, 1)
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
        finally:
            gen.set_state(rng)
            counters.add(counters.difference(before, counters.snapshot()),
                         -1)
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        before = counters.snapshot()
        gc_was_enabled = gc.isenabled()
        gc.disable()  # no finalizer (a graph's, an event's) inside the capture
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.fetches = self._steps(exe, self.chain)
        finally:  # nothing launched while capturing
            if gc_was_enabled:
                gc.enable()
            self.launches = counters.difference(before, counters.snapshot())
            counters.add(self.launches, -1)
        exe.last_capture = {"warmup_s": t1 - t0,
                            "capture_s": time.perf_counter() - t1}

    def serves(self, program: Program, scope: Scope,
               gen: torch.Generator) -> bool:
        """Whether this capture still runs ``program`` on ``scope``."""
        return (program.desc.fingerprint() == self.fingerprint
                and scope is self.scope and gen is self.gen)

    def _steps(self, exe: Executor, count: int) -> List[Any]:
        """``count`` chained steps from the state buffers, step i on feed
        set i % len(feeds), each new state copied into its buffer at the
        end; the last step's fetches."""
        plan, state = self.plan, dict(self.states)
        for i in range(count):
            env = dict(state)
            env.update(self.feeds[i % len(self.feeds)])
            fetches = exe._step(plan, env, self.gen)
            # as the next run() would read them: in the declared dtype
            state = {n: env[n].to(plan.state_dtype(n))
                     for n in plan.state_names if n in env}
        for name, value in state.items():
            buf = self.states.get(name)
            if buf is None:  # written before it is read: the warm-up's
                self.states[name] = value.clone()
            elif value is not buf:
                buf.copy_(value)
        return fetches

    def run(self, exe: Executor, staged, scope: Scope) -> List[Any]:
        """Replay on ``staged`` (the feeds on the card) from ``scope``'s
        state; the last step's fetches (static outputs)."""
        for name, buf in self.states.items():
            value = scope.find_var(name)
            if value is None:
                if name in self.plan.rbw:
                    raise RuntimeError(
                        f"persistable variable '{name}' is read before it "
                        "is written but is not initialized in the scope")
            elif value is not buf:
                buf.copy_(exe._to_device(value, buf.dtype))
        for i in range(self.replays):
            # scan: the one set takes feed i % n before replay i; flat:
            # set j takes feed j
            for j, feed in enumerate(self.feeds):
                for name, buf in feed.items():
                    buf.copy_(staged[(i + j) % len(staged)][name])
            self.graph.replay()
        counters.add(self.launches, self.replays)
        for name, buf in self.states.items():
            scope.set_var(name, buf)
        return self.fetches
