"""Train and eval steps, the counterpart of
`npf_gwwaveform_tpu/training/trainer.py` (`Trainer._step_impl`,
`_eval_step`, `predict`, `train_steps_scanned`, `train_steps_generated`).

A train step splits the batch into contexts and targets, runs the model in
train mode (BatchNorm on batch statistics, its running statistics updated),
computes the criterion's train loss, backpropagates and takes one optimizer
step. Every random draw comes from the state's `torch.Generator`, on the
batch's device: the split's, and a latent model's z draws after it. The
model sees the targets' values in train and eval mode alike, as JAX's
`_apply` passes `Y_trgt` (a latent model with `is_q_zCct` encodes them).
Nothing in a step reads a value back to the host: the metrics are 0-d
device tensors.

`train_steps_generated` and `train_steps_scanned` take many steps: on CUDA
the step is captured once in a CUDA graph (`utils.cuda_graph.StepGraph`,
with the trainer's generator registered) and replayed, so the host launches
one graph a step instead of some 1,650 kernels; on the CPU they take the
eager step. A capture that fails raises.

With `mesh=` (`parallel.make_mesh`) every rank runs the same calls on the
same global batch, its generator seeded alike: each step draws the global
batch's split (and `train_steps_generated` the global batch itself) on
every rank, keeps this rank's rows (`parallel.shard_batch`), runs the
forward and backward inside `parallel.use_mesh` (BatchNorm's statistics over
the data axis, the target sum over the seq axis, the z noise drawn for the
global batch), and then sums every gradient over all ranks in one
all-reduce of their concatenation and divides by the rank count (for a
"sum" criterion: by the seq axis' size), before the clip and the update:
the one-process gradient. The reported loss rides in the same all-reduce:
the global batch's. `eval_step` gathers the per-function losses of the
whole batch. The graphed steps capture the all-reduces too, which NCCL
allows and gloo does not: on a mesh of another backend they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..losses import BaseLossNPF, NPFOutput
from ..parallel.collectives import gather_rows
from ..parallel.mesh import SEQ_AXIS, Mesh, shard_batch, use_mesh
from ..utils.cuda_graph import StepGraph
from .optim import AdamSchedule
from .state import TrainState

__all__ = ["Trainer"]


class Trainer:
    """(model, criterion, optimizer, splitter): splitter(generator, x, y,
    condition=None) -> batch dict (`data.CntxtTrgtSplitter`); `mesh` (None:
    one process) the ranks the steps run on."""

    def __init__(self, model: torch.nn.Module, criterion: BaseLossNPF, optimizer: AdamSchedule,
                 splitter: Callable, generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self.criterion = criterion
        self.eval_criterion = dataclasses.replace(criterion, reduction=None)
        self.splitter = splitter
        if generator is None:
            generator = torch.Generator(device=next(model.parameters()).device).manual_seed(0)
        self.state = TrainState(model, optimizer, generator)
        self.graphs = {}  # the step graphs made so far, by kind and inputs

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def _forward(self, batch: dict, generator: Optional[torch.Generator] = None):
        """The model on a split batch, the targets' values included; a latent
        model draws from `generator` (default: the state's)."""
        return self.model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                          mask_cntxt=batch["mask_cntxt"], mask_trgt=batch["mask_trgt"],
                          condition=batch.get("condition"), y_trgt=batch["Y_trgt"],
                          generator=self.state.generator if generator is None else generator)

    def _split(self, generator: torch.Generator, x, y, cond) -> dict:
        """The split of the (global) batch; on a mesh this rank's rows of it."""
        batch = self.splitter(generator, x, y, condition=cond)
        return batch if self.mesh is None else shard_batch(batch, self.mesh)

    def loss_and_grads(self, batch: dict) -> torch.Tensor:
        """Forward in train mode on a split batch and backward: the loss, with
        every parameter's `.grad` set. Takes no optimizer step. On a mesh the
        batch is this rank's rows (`_split`), and the loss and gradients are
        the global batch's (`_all_reduce_grads`)."""
        self.model.train()
        self.state.optimizer.zero_grad()
        with use_mesh(self.mesh):
            loss = self.criterion(self._forward(batch), batch["Y_trgt"], batch["mask_trgt"],
                                  train=True)
            loss.backward()
        loss = loss.detach()
        return loss if self.mesh is None else self._all_reduce_grads(loss)

    def _all_reduce_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Sum every gradient and the loss over all ranks in one all-reduce
        and divide by the rank count ("mean" criterion) or the seq axis' size
        ("sum": the seq ranks hold one loss) -> the global loss."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).float()])
        dist.all_reduce(flat)
        flat /= self.mesh.size if self.criterion.reduction == "mean" else self.mesh.axis_size(
            SEQ_AXIS)
        parts = flat[:-1].split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])
        return flat[-1]

    def _update(self, x, y, cond) -> dict:
        """The step's device work: split, forward, loss, backward, update."""
        loss = self.loss_and_grads(self._split(self.state.generator, x, y, cond))
        return {"loss": loss, "grad_norm": self.state.optimizer.step()}

    def _step(self, x, y, cond) -> dict:
        metrics = self._update(x, y, cond)
        self.state.step += 1
        return metrics

    def train_step(self, x, y) -> dict:
        """One update on raw (x [B,N,1], y [B,N,y_dim]) -> {loss, grad_norm}."""
        return self._step(x, y, None)

    def train_step_cond(self, x, y, cond) -> dict:
        """As `train_step`, conditioned on cond [B, cond_dim]."""
        return self._step(x, y, cond)

    @torch.no_grad()
    def eval_step(self, x, y, generator: torch.Generator, cond=None) -> torch.Tensor:
        """Per-function eval loss [B] (NPML forced) in eval mode, split (and a
        latent model's z drawn) with the given generator; on a mesh every
        function of the global batch, gathered over the data axis."""
        self.model.eval()
        batch = self._split(generator, x, y, cond)
        with use_mesh(self.mesh):
            loss = self.eval_criterion(self._forward(batch, generator), batch["Y_trgt"],
                                       batch["mask_trgt"], train=False)
        return loss if self.mesh is None else gather_rows(loss, self.mesh)

    @torch.no_grad()
    def predict(self, batch: dict) -> NPFOutput:
        """The eval-mode forward on an already split batch (a latent model's
        draws from the state's generator), the whole batch on every rank of a
        mesh."""
        self.model.eval()
        return self._forward(batch)

    def _save_state(self):
        """Copies of what a step moves besides the generator (parameters,
        buffers, the optimizer's state) -> a function that puts them back and
        leaves every `.grad` unset, as a capture wants."""
        tensors = [*self.model.parameters(), *self.model.buffers()]
        saved = [t.detach().clone() for t in tensors]
        restore_optimizer = self.state.optimizer.save_state()

        def restore() -> None:
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            restore_optimizer()
            self.state.optimizer.zero_grad()
        return restore

    def _graph(self, key, fn, inputs=()) -> StepGraph:
        if self.mesh is not None and self.mesh.backend != "nccl":
            raise ValueError(f"a CUDA graph cannot capture {self.mesh.backend} collectives: "
                             "train this mesh with train_step, or on an NCCL mesh")
        if key not in self.graphs:
            self.graphs[key] = StepGraph(fn, inputs, self.model, [self.state.generator],
                                         self._save_state)
        return self.graphs[key]

    def generated_graph(self, sample_fn: Callable) -> StepGraph:
        """The train step on `sample_fn(generator) -> (x, y, cond)`'s batch,
        sampling included, as a CUDA graph (captured at its first replay; one
        per `sample_fn`)."""
        return self._graph(("generated", sample_fn),
                           lambda: self._update(*sample_fn(self.state.generator)))

    def scanned_graph(self, x, y, cond=None) -> StepGraph:
        """The train step on static inputs shaped as (x, y, cond) as a CUDA
        graph (one per shapes and types); a replay takes the batch."""
        shapes = tuple(None if t is None else (t.shape, t.dtype) for t in (x, y, cond))
        inputs = [t.clone() for t in (x, y, cond) if t is not None]
        return self._graph(("scanned", shapes),
                           lambda *a: self._update(a[0], a[1], a[2] if len(a) > 2 else None),
                           inputs)

    def _on_cuda(self) -> bool:
        return next(self.model.parameters()).device.type == "cuda"

    def train_steps_generated(self, sample_fn: Callable, n_steps: int) -> torch.Tensor:
        """`n_steps` train steps, each on a batch `sample_fn(generator) -> (x,
        y, cond)` draws on the device (cond may be None) -> the per-step
        losses [n_steps] on the device. On CUDA the step is replayed from
        `generated_graph`; on the CPU it runs eagerly."""
        graph = self.generated_graph(sample_fn) if self._on_cuda() else None
        losses = torch.empty((n_steps,), device=self.state.generator.device)
        for i in range(n_steps):
            if graph is not None:
                metrics = graph.replay()
            else:
                metrics = self._update(*sample_fn(self.state.generator))
            losses[i] = metrics["loss"]
            self.state.step += 1
        return losses

    def train_steps_scanned(self, xs, ys, conds=None) -> torch.Tensor:
        """One train step on each stacked batch (xs [n, B, N, 1], ys [n, B, N,
        y_dim], conds [n, B, cond_dim] or None) in order -> the per-step losses
        [n]. On CUDA batch i is copied into `scanned_graph`'s inputs and the
        graph replayed; on the CPU the step runs eagerly."""
        batches = [(xs[i], ys[i], None if conds is None else conds[i]) for i in range(xs.shape[0])]
        graph = self.scanned_graph(*batches[0]) if batches and self._on_cuda() else None
        losses = torch.empty((len(batches),), device=xs.device)
        for i, (x, y, cond) in enumerate(batches):
            if graph is not None:
                metrics = graph.replay(*(t for t in (x, y, cond) if t is not None))
            else:
                metrics = self._update(x, y, cond)
            losses[i] = metrics["loss"]
            self.state.step += 1
        return losses
