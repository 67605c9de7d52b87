"""``Engine.run_compiled`` and ``ShardedEngine.run_compiled`` on CUDA: the
tick as CUDA graphs.

The reference jits the tick and runs ``n_ticks`` of it in one
``lax.fori_loop`` (``deneva_tpu/engine/scheduler.py:1191-1243``).  Here one
tick is captured into a ``torch.cuda.CUDAGraph`` per flush phase (the
write ring is flushed after every ``FLUSH_EVERY``-th tick, so only the
last phase's graph ends with the flush), and a run replays them in phase
order.  An engine names its phase count in ``graph_phases``: the sharded
engine applies its writes at the owners, keeps no ring, and takes one
graph of the whole cluster tick.  A replay launches every kernel of the
tick from one host call and reads nothing back.

What a captured tick keeps to (a later slice's tick too):

- it reads no device value on the host: no ``.item()``, ``bool()``,
  ``int()`` or element store from the host.  It is the engine's tick made
  with ``on_device``: a data-dependent branch runs a body that is exact on
  every tick and counts the reference's choice
  (``WorkloadPlugin.effect_branch``), and a data-dependent loop stays
  exact in one of three forms: a closed form (TPC-C's restock chain), the
  reference's own static bound, or a conditional WHILE node of the graph
  (``ops/device_loop.run_while``: OCC's validation fixed point), whose
  body runs until the device says stop;
- every tensor that outlives the tick is a static buffer or a counter
  made before the capture;
- every lazy start-up (the kernel's build and load, its occupancy query
  per key count, the WHILE node's library and body stream, a loop's pass
  counter, PyTorch's own) happens in the warm-up, on a side stream,
  before the capture.

The graphs run on static buffers, a state made by the engine's
``init_state`` (an ``EngineState``, or a ``ShardState`` whose tensors
carry a leading node axis).  Inside each graph, the tick's new tensors (the
``TxnState`` fields, ``pool_cursor``, ``ts_counter``, ``tick``) are
copied back into those buffers; what the tick updates in place
(``stats``, ``data``, ``tables``, ``db``: TIMESTAMP's ``wts`` and ``rts``
by in-place scatter-max and rebase, MVCC's rings by ``index_copy_`` as
well) is the buffer itself.  So the state a replay returns is those
buffers, and the next replay overwrites it.  The phase graphs share one
memory pool: each one's intermediates die inside it, so replays in any
order on one stream are safe.  WHILE bodies allocate from a pool that
``ops/device_loop.py`` keeps per device, by the same argument.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from deneva_tpu_torch.engine.scheduler import EngineState
from deneva_tpu_torch.ops import fused


@contextlib.contextmanager
def no_collection_in_capture():
    """Run no automatic garbage collection inside the block (a capture): a
    dead reference cycle that holds a CUDA graph (an engine and its
    ``TickGraphs``) collected while a stream captures destroys that graph
    there, which CUDA does not permit, and the capture fails.  The cycle
    is collected later, outside any capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def state_items(state: EngineState) -> list:
    """Every tensor of an engine state with its name, in a fixed order."""
    out = [(f"txn.{f}", v) for f, v in zip(state.txn._fields, state.txn)]
    out += [(f, getattr(state, f))
            for f in ("data", "tick", "pool_cursor", "ts_counter")]
    for part in ("db", "tables", "stats"):
        d = getattr(state, part)
        out += [(f"{part}.{k}", d[k]) for k in sorted(d)]
    return out


class TickGraphs:
    """The tick of one engine captured once per flush phase
    (``engine.graph_phases`` graphs), with its static buffers (``static``)
    and the kernel launches by pack that one replay of each phase graph
    makes (``launches``)."""

    def __init__(self, engine):
        self.engine = engine
        self.phases = engine.graph_phases
        self.static = engine.init_state()
        self.names = [k for k, _ in state_items(self.static)]
        self.buffers = [v for _, v in state_items(self.static)]
        self._storages = {v.untyped_storage().data_ptr()
                          for v in self.buffers}
        self.launches: list = []
        self._warm_up()
        pool = torch.cuda.graph_pool_handle()
        self.graphs = [self._capture(p, pool) for p in range(self.phases)]

    def _warm_up(self) -> None:
        """One tick of each phase on a side stream, the tick that is
        captured; the workload's counters are restored after it."""
        eng = self.engine
        dev = eng.device
        saved = {k: v.clone() for k, v in eng.workload.counters.items()}
        if eng.cfg.fused_arbitrate:
            fused.warm()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            st = self.static
            for phase in range(self.phases):
                st = eng.tick(st._replace(host_tick=phase), compiled=True)
        torch.cuda.current_stream(dev).wait_stream(side)
        for k, v in saved.items():
            eng.workload.counters[k].copy_(v)
        torch.cuda.synchronize(dev)

    def _capture(self, phase: int, pool) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        before = dict(fused.LAUNCHES_BY_PACK)
        try:
            with no_collection_in_capture(), \
                    torch.cuda.graph(graph, pool=pool):
                out = self.engine.tick(self.static._replace(host_tick=phase),
                                       compiled=True)
                self._write_back(out)
        except RuntimeError as err:
            raise RuntimeError(f"CUDA graph capture of the tick (flush phase "
                               f"{phase}) failed: {err}") from err
        self.launches.append({k: v - before.get(k, 0)
                              for k, v in fused.LAUNCHES_BY_PACK.items()
                              if v != before.get(k, 0)})
        return graph

    def _write_back(self, out: EngineState) -> None:
        """Copy the tick's new tensors into the static buffers (captured)."""
        items = state_items(out)
        if [k for k, _ in items] != self.names:
            raise ValueError("the tick returned other tensors than its "
                             "state's")
        for name, dst, (_, src) in zip(self.names, self.buffers, items):
            if src is dst:
                continue
            if src.untyped_storage().data_ptr() in self._storages:
                raise ValueError(f"the tick's {name} is a view of a state "
                                 "buffer; a captured tick must return new "
                                 "tensors or the buffers themselves")
            dst.copy_(src)

    def replay(self, n_ticks: int, state: EngineState) -> EngineState:
        """Copy `state` into the static buffers (each tensor that is not
        already one), replay n_ticks phase graphs from ``state.host_tick``
        and return the buffers as a state, valid until the next replay."""
        items = state_items(state)
        if [k for k, _ in items] != self.names:
            raise ValueError("the state's tensors are not this engine's")
        for name, dst, (_, src) in zip(self.names, self.buffers, items):
            if src is dst:
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"state {name}: {src.dtype}"
                                 f"{tuple(src.shape)} != the engine's "
                                 f"{dst.dtype}{tuple(dst.shape)}")
            dst.copy_(src)
        t = state.host_tick
        for _ in range(n_ticks):
            self.graphs[t % self.phases].replay()
            t += 1
        return self.static._replace(host_tick=t)

    def launches_of(self, host_tick: int, n_ticks: int) -> dict:
        """Kernel launches by pack that n_ticks replays from ``host_tick``
        make: the sum of the phase graphs' captured launches."""
        out: dict = {}
        for t in range(host_tick, host_tick + n_ticks):
            for k, v in self.launches[t % self.phases].items():
                out[k] = out.get(k, 0) + v
        return out
