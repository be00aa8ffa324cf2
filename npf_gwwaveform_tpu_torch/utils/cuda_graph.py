"""One step of work captured in a CUDA graph and replayed: the port's
counterpart of the JAX package's compiled step loops (`jax.jit` around a
`lax.scan` of train steps, the jitted eval batch), which the host dispatches
once for many steps.

`StepGraph(fn, inputs, model, generators, save_state, warmup_calls)`
captures `fn(*inputs)` at its first replay, following PyTorch's
whole-network pattern: `warmup_calls` eager calls on a side stream first (so
that cuBLAS and cuDNN handles, cuFFT plans, the kernel library and the
optimizer's lazily made state exist; 0 where the caller's own eager calls
did that), then every state those calls moved is put back (the generators'
states, and whatever `save_state` saved: parameters, buffers, optimizer
state), then one capture. A replay copies its arguments into the static
`inputs`, launches the graph and returns the static outputs, which the next
replay overwrites; `replays` counts them.

Random draws come from the registered `generators`: each replay draws what
the next eager call would have drawn, and advances them as it would. The
kernel wrappers' launch counters advance at the warm-up calls and at the
capture, never at a replay: they count launches the host made, and a replay
launches what was captured.

Capture needs CUDA: a model, an input or a generator on another device is
refused with an error, and so is a failed capture. There is no eager
fallback.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

__all__ = ["WARMUP_CALLS", "StepGraph", "require_cuda"]

WARMUP_CALLS = 3  # eager calls before the capture, as PyTorch's example takes


def require_cuda(model: Optional[torch.nn.Module] = None, tensors: Sequence = (),
                 generators: Sequence = ()) -> None:
    """Raise unless every parameter and buffer of `model`, every tensor and
    every generator is on a CUDA device."""
    named = [] if model is None else [*model.named_parameters(), *model.named_buffers()]
    named += [(f"input {i}", t) for i, t in enumerate(tensors)]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA graph capture: {name} is on {t.device}, not on CUDA")
    for i, g in enumerate(generators):
        if g.device.type != "cuda":
            raise ValueError(f"CUDA graph capture: generator {i} is on {g.device}, not on CUDA")


class StepGraph:
    """fn(*inputs) -> outputs (tensors, or a tuple or dict of them), captured
    in a CUDA graph at the first replay (or at `capture`) and replayed.
    `save_state()` saves what a call moves besides the generators and returns
    a function that puts it back; it runs before the warm-up and its
    function after it."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor] = (),
                 model: Optional[torch.nn.Module] = None, generators: Sequence = (),
                 save_state: Optional[Callable[[], Callable[[], None]]] = None,
                 warmup_calls: int = WARMUP_CALLS):
        require_cuda(model, inputs, generators)
        self.fn, self.inputs, self.generators = fn, tuple(inputs), tuple(generators)
        self.save_state, self.warmup_calls = save_state, warmup_calls
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.replays = 0
        self._warm = False

    def warm_up(self) -> None:
        """`warmup_calls` eager calls on a side stream; then every state they
        moved is put back."""
        restore = self.save_state() if self.save_state is not None else None
        gen_states = [g.get_state() for g in self.generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.warmup_calls):
                self.fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        if restore is not None:
            restore()
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        self._warm = True

    def capture(self) -> None:
        """Warm up (unless done) and capture one call on a side stream, as
        `torch.cuda.graph` does but without first emptying the allocator's
        cache (and, in some PyTorch versions, collecting garbage), which the
        capture does not need and which only add to its cost."""
        if not self._warm:
            self.warm_up()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                self.outputs = self.fn(*self.inputs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = graph

    def replay(self, *args: torch.Tensor):
        """Copy `args` into the static inputs, launch the graph (captured
        first if need be) and return its static outputs."""
        if self.graph is None:
            self.capture()
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        self.replays += 1
        return self.outputs
