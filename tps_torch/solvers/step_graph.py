"""The solver's time step as a CUDA graph: captured once, then replayed.

The JAX solver runs chunks of up to 64 steps as one compiled program, a
lax.scan over its step body (tps_tpu/solvers/compressible.py:697-729).
PyTorch's counterpart of a compiled scan is a captured CUDA graph: the
host launches one graph per step instead of the ~250 operations of a
slot-path RHS times the RK stages.  One graph of one step, replayed n
times, serves every chunk length with one memory pool.

`StepLoop` keeps the step's state in static buffers (U, t, dt, the
boundary conditions' ghost states and a ring of the last RING steps' max
characteristic speed) and runs
`body(U, t, dt, bc) -> (U', t', dt', mcs, bc')` on them in place (bc: a
tuple with a tensor for each stateful BC, None for the others):

- on the CPU, and on CUDA when the caller turns graphs off, the body
  runs eagerly;
- on CUDA the first step runs eagerly on a side stream.  It builds the
  kernels, fills the operators' caches (host-to-device copies) and sets
  the kernels' shared-memory attributes, none of which belongs inside a
  capture.  Then one step is captured (a capture runs nothing) and every
  step from then on, the second one included, is a replay.

A capture that meets a host sync or a pageable copy raises (PyTorch
captures in the global error mode), and so does a failed replay.  Nothing
falls back to eager stepping.

The kernels' wrappers count a launch per Python call (the `launches`
dicts of dg/cuda_fused.py and dg/cuda_faces.py), so a capture would count
launches that never ran and a replay none.  The loop takes what the
capture added back off and adds it again at every replay: the counts stay
launches.

Whatever the body changes between steps must live in these buffers: a
graph replays the capture's addresses, never a Python rebinding.  So the
BC ghost states are buffers too: the RHS reads `bc_states` (the same
tensors), the body returns the new states and the step copies them in.
"""

from __future__ import annotations

import time

import torch

RING = 64  # the longest chunk (the JAX solver's, _chunk_size)


class StepLoop:
    """Static buffers U, t, dt, BC states, ring; `run(n)` advances them n
    steps."""

    def __init__(self, body, U, dt, bc_states=(), counters=()):
        self.body = body
        self.U = U.detach().clone().contiguous()
        kw = {"dtype": self.U.dtype, "device": self.U.device}
        self.t = torch.zeros((), **kw)
        self.dt = torch.full((), float(dt), **kw)
        self.bc_states = tuple(None if b is None else b.detach().clone()
                               for b in bc_states)
        self.ring = torch.zeros(RING, **kw)
        self.counters = counters
        self.graph = None
        self.per_replay = None  # kernel launches of one replay, per counter
        self.capture_s = None  # wall seconds of the capture
        self.pool_bytes = None  # device memory the graph's pool reserved

    def load(self, U, t, dt):
        """Copy state the caller rebound (a tensor or a number) into the
        buffers; the buffers themselves are left as they are."""
        for buf, v in ((self.U, U), (self.t, t), (self.dt, dt)):
            if v is buf:
                continue
            if isinstance(v, torch.Tensor):
                buf.copy_(v)
            else:
                buf.fill_(float(v))

    def load_bc_states(self, bc_states):
        """Copy new BC ghost states into the buffers (set-up, restart)."""
        for buf, v in zip(self.bc_states, bc_states):
            if buf is not None:
                buf.copy_(v)

    def _step(self):
        U, t, dt, mcs, bcs = self.body(self.U, self.t, self.dt, self.bc_states)
        self.load_bc_states(bcs)
        self.U.copy_(U)
        self.t.copy_(t)
        if dt is not self.dt:
            self.dt.copy_(dt)
        self.ring.copy_(torch.cat((self.ring[1:], mcs.reshape(1))))

    def _capture(self):
        """The warm-up step on a side stream, then one step captured."""
        dev = self.U.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = [dict(c) for c in self.counters]
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._step()
        finally:
            # what the capture recorded is not a launch
            self.per_replay = [{k: c[k] - b.get(k, 0) for k in c}
                               for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                c.update(b)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph

    def run(self, n, graph=True):
        """n steps (1 <= n <= RING): replays of the step graph on CUDA
        (capturing it first if there is none), eager steps on the CPU or
        with graph=False.  The last n max char speeds end the ring."""
        if not 1 <= n <= RING:
            raise ValueError(f"a chunk takes 1..{RING} steps, not {n}")
        if self.U.device.type != "cuda" or not graph:
            for _ in range(n):
                self._step()
            return
        if self.graph is None:
            self._capture()
            n -= 1  # the warm-up was a step
        for _ in range(n):
            self.graph.replay()
            for c, d in zip(self.counters, self.per_replay):
                for k, v in d.items():
                    c[k] += v

    def speeds(self, n):
        """The last n steps' max char speeds on the host, and the CUDA
        event to wait for before reading them (None on the CPU): the copy
        is queued behind the chunk, so the host need not wait for it."""
        last = self.ring[RING - n:]
        if last.device.type != "cuda":
            return last.clone(), None
        host = torch.empty(n, dtype=last.dtype, pin_memory=True)
        host.copy_(last, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
