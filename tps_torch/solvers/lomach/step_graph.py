"""The low-Mach step on the card: CG in blocks, each step replayed as CUDA graphs.

The JAX package runs a low-Mach chunk as one compiled program: a
lax.scan over steps whose CG solves are lax.while_loops on the device
(tps_tpu/solvers/lomach/solver.py:722-765, tps_tpu/fem/h1.py:620-641).
A CUDA graph holds no loop whose length depends on the data, so here a
step is captured as segments:

    [work before solve 1] [block of solve 1] [work between 1 and 2] ...
    [block of solve n] [work after solve n]

where a block is `k` masked CG iterations (fem/h1.py: after convergence
an iteration changes nothing).  A replay runs the segments in order and
replays each solve's block until the solve's device status says done:
one host read of the status per check.  The reads are speculative: a
solve first runs one block fewer than it needed the step before, then
one block a read, so a solve whose iteration count holds costs two reads
and no block past convergence; a count that drops runs a few blocks too
many.  Those are exact no-ops, so eager steps (which run the same blocks
through the same `SolveLoops`) and replays give the same bits whatever
the speculation did.

Every tensor the step reads or writes across steps lives in the models'
buffers, updated in place (solvers/lomach/base.py); the ramped inlet
reads the device time; the lagged dense factors are refreshed outside the
graph, into the same tensors: before a replay, or as host work at a point
between two segments (`SolveLoops.host`), which every replay runs there.
A capture that meets a host sync raises (PyTorch captures in the global
error mode); nothing falls back.  The cycle collector is paused while a
step captures (solvers/step_graph.py's `collector_paused`: a dead graph
destroyed inside a capture ends it).
"""

from __future__ import annotations

import time

import torch

from ..step_graph import collector_paused


class SolveLoops:
    """Runs the blocks of a step's CG solves (the `loops` of fem/h1.py's
    cg_solve): eagerly, reading each solve's status after its blocks, or,
    while a StepGraph captures, by capturing the block as a graph of its
    own.  The i-th solve of a step is solve i in `blocks` (the blocks it
    needed the last time) and in a graph's items."""

    def __init__(self):
        self.reads = 0  # host reads of a solve's status so far
        self.blocks = {}
        self.index = 0
        self.capturing = None  # the StepGraph that is capturing

    def begin_step(self):
        self.index = 0

    def __call__(self, run, status, k):
        i = self.index
        self.index += 1
        if self.capturing is not None:
            self.capturing.split(run, status, i, k)
        else:
            self.spin(run, status, i, k)

    def host(self, fn):
        """Host work between two parts of a step (a lagged factor refresh
        when due): run now, or, while a StepGraph captures, at this point
        of every replay."""
        if self.capturing is not None:
            self.capturing.host_point(fn)
        else:
            fn()

    def spin(self, run, status, i, k):
        """Blocks of solve i until its status (done, iterations) says done:
        first one fewer than it needed the last time (at least one), then
        one a read."""
        n = max(self.blocks.get(i, 1) - 1, 1)
        while True:
            for _ in range(n):
                run()
            self.reads += 1
            done, iters = status.tolist()
            if done:
                break
            n = 1
        self.blocks[i] = max(-(-iters // k), 1)


class StepGraph:
    """One step captured as CUDA graphs (module doc); `replay` runs it."""

    def __init__(self, loops, stream):
        self.loops = loops
        self.stream = stream  # the capture stream (warm-up ran there too)
        # (graph, None) for a segment, (graph, (status, i, k)) for a block,
        # (None, fn) for host work between segments
        self.items = []
        self.pool = torch.cuda.graph_pool_handle()
        self.capture_s = None  # wall seconds of the capture
        self.pool_bytes = None  # device memory the graphs' pool reserved
        self.replays = 0  # steps replayed so far
        self._segment = None

    def capture(self, body):
        """Capture body() (which runs its solves through self.loops); the
        capture runs nothing."""
        dev = self.stream.device
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.synchronize(dev)
        with collector_paused(), torch.cuda.stream(side):
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            self.loops.capturing = self
            self.loops.begin_step()
            try:
                self._open()
                body()
                self._close()
            finally:
                self.loops.capturing = None
                if self._segment is not None:  # a failed capture
                    g, self._segment = self._segment, None
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass  # the error that stopped the capture propagates
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _open(self):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool)
        self._segment = g

    def _close(self):
        g, self._segment = self._segment, None
        g.capture_end()
        self.items.append((g, None))

    def split(self, run, status, i, k):
        """A solve met during capture: close the segment, capture one block
        as its own graph, open the next segment."""
        self._close()
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool)
        self._segment = g
        run()
        self._segment = None
        g.capture_end()
        self.items.append((g, (status, i, k)))
        self._open()

    def host_point(self, fn):
        """Host work met during capture: close the segment, run fn at this
        point of every replay, open the next segment."""
        self._close()
        self.items.append((None, fn))
        self._open()

    def replay(self):
        self.replays += 1
        for g, solve in self.items:
            if g is None:
                solve()
            elif solve is None:
                g.replay()
            else:
                self.loops.spin(g.replay, *solve)

    @property
    def graphs(self):
        return sum(g is not None for g, _ in self.items)
