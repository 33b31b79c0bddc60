"""A training or evaluation step run as one CUDA-graph replay.

Counterpart of the ``lax.scan`` bodies of the JAX package: the train epoch
(dahitra_tpu/train/engine.py ``_train_epoch_scan_impl``), the validation
epoch (``_val_epoch_scan_impl``), ``CDEvaluator.eval_epoch_scan``
(evalx/evaluator.py) and the xBD chunk (train/xbd_engine.py
``_train_chunk_scan_impl``). JAX traces the body once and runs the whole
loop as one program; here the body is captured once as a CUDA graph and
each step is one ``replay()``, in place of the thousand-odd launches of an
eager step.

``StepGraph(body, device, name)``: ``body(slot)`` runs one step. It reads
only tensors that stay at their addresses from step to step: the staged
dataset, the parameters, buffers and optimizer state (all updated in
place), and ``slot``, an int64 scalar on the device that counts the steps
since ``reset`` (the body indexes the staged batches with it; the graph
adds 1 to it after each step). It writes its outputs into buffers of the
caller's, in place. On a CUDA device the constructor

  * runs ``warmup`` steps on a side stream (``capture_stream``, which the
    capture uses too), which build every kernel at
    first use (``kernels/_build.py``), fill K2's occupancy cache and, under
    DistributedDataParallel, let DDP settle (PyTorch's whole-network
    capture asks for 11 eager DDP iterations first);
  * captures one step with ``torch.cuda.graph``, the ``generators`` (the
    trainer's augmentation and dropout generators) registered with the
    graph, so that each replay draws what the same eager step would draw
    and leaves the generators' states where it would;
  * puts back what the warm-up changed: the parameters and buffers of the
    ``keep`` modules, the optimizer's state (a state that the warm-up
    created starts again from zeros, as a fresh AdamW state does) and the
    generators' states. The graph's first replay is then the step the run
    would have taken first.

A capture that fails raises and names the last operation it reached; on a
CUDA device there is no eager fallback. On the CPU there is no graph: each
call runs ``body`` eagerly. That eager loop is the graph's plain version,
and the CPU tests hold it against the eager per-batch steps.

``EvalScan``: the eval forward over staged full batches as such replays,
one per batch, accumulating the confusion matrix (or keeping each sample's
matrix) in a buffer on the device.
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode


_STREAMS: dict = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream on which ``StepGraph`` warms up and captures on this
    CUDA device. A DistributedDataParallel whose step a graph will capture
    is built on it too (``core/mesh.py`` ``wrap_ddp``): DDP keeps the
    parameters' gradient accumulators alive, and each keeps the stream it
    was made on, which the captured backward must not leave."""
    device = torch.device(device)
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(key)
    return _STREAMS[key]


class _LastOp(TorchDispatchMode):
    """Remembers the last ATen operation dispatched (for the message of a
    failed capture)."""

    def __init__(self):
        super().__init__()
        self.name = "the first operation"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.name = str(func)
        return func(*args, **(kwargs or {}))


class StepGraph:
    def __init__(self, body: Callable[[torch.Tensor], None],
                 device: torch.device, name: str,
                 generators: Sequence[torch.Generator] = (),
                 keep: Iterable[torch.nn.Module] = (),
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 warmup: int = 3):
        self.body = body
        self.name = name
        self.device = torch.device(device)
        self.slot = torch.zeros((), dtype=torch.long, device=self.device)
        self.graph = None
        if self.device.type == "cuda":
            self.graph = self._capture(list(generators), list(keep),
                                       optimizer, warmup)

    def _step(self) -> None:
        self.body(self.slot)
        self.slot.add_(1)

    def _capture(self, generators, keep, optimizer, warmup):
        tensors = [t for m in keep
                   for t in itertools.chain(m.parameters(), m.buffers())]
        saved = [t.detach().clone() for t in tensors]
        opt_saved = {} if optimizer is None else {
            p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
            for p, st in optimizer.state.items()}
        gen_saved = [g.get_state() for g in generators]
        current = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.slot.zero_()
                self._step()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        last = _LastOp()
        try:
            with torch.cuda.graph(graph, stream=side), last:
                self._step()
        except Exception as e:
            raise RuntimeError(
                f"CUDA-graph capture of the {self.name} failed at "
                f"{last.name}: {e}") from e
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
            for p, st in ({} if optimizer is None else optimizer.state).items():
                old = opt_saved.get(p)
                for k, v in st.items():
                    if torch.is_tensor(v):
                        v.copy_(old[k]) if old is not None else v.zero_()
        for g, s in zip(generators, gen_saved):
            g.set_state(s)
        self.slot.zero_()
        return graph

    def reset(self) -> None:
        """The next step is step 0 of the staged batches."""
        self.slot.zero_()

    def __call__(self) -> None:
        """One step: a replay of the graph, or ``body`` on the CPU."""
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()


class EvalScan:
    """``cm_fn(a_u8, b_u8, l_u8)`` (the eval step's confusion matrix of one
    batch, per sample when ``per_sample``) over the staged full batches
    ``stack`` ((n, B, ...) uint8 tensors on ``device``), one step per batch.
    Captured once; each call runs every batch and returns the summed
    (C, C) matrix or the (n, B, C, C) per-sample matrices, int64."""

    def __init__(self, cm_fn, stack: Sequence[torch.Tensor], n_class: int,
                 device: torch.device, per_sample: bool = False):
        self.n = stack[0].shape[0]
        with torch.inference_mode():
            self.out = torch.zeros(
                (self.n, stack[0].shape[1], n_class, n_class) if per_sample
                else (n_class, n_class), dtype=torch.long, device=device)

        def body(slot):
            i = slot.view(1)
            with torch.inference_mode():
                cm = cm_fn(*(t.index_select(0, i)[0] for t in stack))
                if per_sample:
                    self.out.index_copy_(0, i, cm[None])
                else:
                    self.out.add_(cm)

        self.step = StepGraph(body, device, "eval forward")

    def __call__(self) -> torch.Tensor:
        with torch.inference_mode():
            self.out.zero_()
        self.step.reset()
        for _ in range(self.n):
            self.step()
        return self.out
