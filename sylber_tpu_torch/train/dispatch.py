"""K distillation steps a dispatch (``steps_per_dispatch``).

Port of the JAX loop's multi-step dispatch (``sylber_tpu/train/loop.py``,
K steps folded into one ``lax.scan`` over the device-resident corpus). Here
a dispatch runs K steps of :func:`train/distill.py::make_train_step` on
static device buffers:

- at its start the host copies, through pinned memory, the K index vectors
  of the batches ((K, B), from the same index stream as the one-step loop's)
  and the K device rows of the steps ([merge threshold, learning rate],
  (K, 2) float32) into static buffers, and resets a device cursor;
- each step reads its row and gathers its batch at the cursor, runs, writes
  its metrics into row ``cursor`` of a (K, n) buffer and advances the cursor:
  nothing in a step depends on a host value that changes between steps;
- between steps the host only reseeds the step's generators
  (``StepRandom``).

On CUDA the step is captured in a ``torch.cuda.CUDAGraph`` (one per position
in the accumulation window, the positions' graphs sharing one memory pool)
after one eager step of that position on a side stream, and the dispatch
replays it K times back to back; the step's generators are registered with
each graph, so a replay reads the seeds the host set before it. The host
waits once a dispatch, for the one before (its metrics are fetched only
where a step of it is logged). A failed capture or replay raises. On the CPU
the same steps run eagerly on the same buffers, so the CPU tests run this
code.

The kernels' launch counters see a captured kernel once, at the capture:
:attr:`StepDispatch.replays` counts the replays beside them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.device import _pinned


class StepDispatch:
    """The static buffers and graphs of K-step dispatches of ``step_fn``
    (``make_train_step``'s) over ``data`` (``precollate``'s batch of the
    whole corpus on ``device``)."""

    def __init__(self, step_fn, cfg, data: Dict[str, Optional[torch.Tensor]], batch_size: int,
                 steps: int, device):
        self.values, self.reseed, self.run = step_fn.values, step_fn.reseed, step_fn.run
        self.cfg = cfg
        self.device = torch.device(device)
        self.K, self.B = int(steps), int(batch_size)
        self.data = {k: v for k, v in data.items() if v is not None}
        self.absent = [k for k, v in data.items() if v is None]
        self.idx = torch.zeros(self.K, self.B, dtype=torch.int64, device=self.device)
        self.rows = torch.zeros(self.K, 2, dtype=torch.float32, device=self.device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.keys: Optional[List[str]] = None
        self.out: Optional[torch.Tensor] = None
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.warm: set = set()
        self.pool = None
        self.capture_s = 0.0    # host seconds spent capturing
        self.replays = 0        # graph replays so far
        self.eager_steps = 0    # steps run eagerly (the CPU, the warm-up)
        self._done: Optional[torch.cuda.Event] = None

    def _step(self, state, lr: float) -> None:
        """One step on the static buffers at the cursor (eager or captured)."""
        at = self.cursor
        idx = self.idx.index_select(0, at).view(-1)
        row = self.rows.index_select(0, at).view(-1)
        batch = {k: v.index_select(0, idx) for k, v in self.data.items()}
        batch.update({k: None for k in self.absent})
        metrics = self.run(state, batch, row, lr)
        if self.keys is None:
            self.keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
            self.out = torch.zeros(self.K, len(self.keys), dtype=torch.float32,
                                   device=self.device)
        stacked = torch.stack([metrics[k].detach().float() for k in self.keys])
        self.out.index_copy_(0, at, stacked[None])
        self.cursor.add_(1)

    def _capture(self, state) -> torch.cuda.CUDAGraph:
        """The step at the state's position in the accumulation window
        captured; the state's host step count is left as it was."""
        if any(not isinstance(g["lr"], torch.Tensor) for g in state.optimizer.param_groups):
            raise ValueError("steps_per_dispatch on CUDA needs the capturable optimizer of "
                             "init_train_state (a learning rate in device memory)")
        t0 = time.perf_counter()
        step0 = state.step
        # the eager warm-up's freed blocks back to the device: the graph's
        # pool holds a whole step's activations of its own
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for g in state.rng.generators():
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, pool=self.pool):
            self._step(state, 0.0)
        if self.pool is None:
            self.pool = graph.pool()
        state.step = step0
        self.capture_s += time.perf_counter() - t0
        return graph

    def _eager(self, state, lr: float) -> None:
        """An eager step; on CUDA on a side stream (the warm-up before a capture)."""
        self.eager_steps += 1
        if self.device.type != "cuda":
            self._step(state, lr)
            return
        side, cur = torch.cuda.Stream(self.device), torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._step(state, lr)
        cur.wait_stream(side)

    def dispatch(self, state, seed: int, indices: np.ndarray) -> Optional[torch.Tensor]:
        """Steps ``state.step`` to ``state.step + len(indices) - 1`` on the
        batches ``indices`` ((n, B), n <= K); returns their metrics, an (n,
        len(keys)) float32 device tensor (``keys``: their names)."""
        n = len(indices)
        if self._done is not None:
            self._done.synchronize()  # the host waits once a dispatch
        vals = [self.values(seed, state.step + j) for j in range(n)]
        self.idx[:n].copy_(_pinned(np.asarray(indices, np.int64), self.device),
                           non_blocking=True)
        self.rows[:n].copy_(_pinned(np.asarray(vals, np.float32), self.device),
                            non_blocking=True)
        self.cursor.zero_()
        k = self.cfg.accumulate_grad_batches
        for j in range(n):
            self.reseed(state, seed, state.step)
            pos = state.step % k
            if self.device.type != "cuda" or pos not in self.warm:
                self._eager(state, vals[j][1])
                self.warm.add(pos)
                continue
            graph = self.graphs.get(pos)
            if graph is None:
                graph = self.graphs[pos] = self._capture(state)
                self.reseed(state, seed, state.step)  # the capture drew nothing
            graph.replay()
            self.replays += 1
            state.step += 1
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record()
        return self.out[:n]
