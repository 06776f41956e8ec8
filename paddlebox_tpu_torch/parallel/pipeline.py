"""Pipeline parallelism — microbatch pipelines over the ``pp`` axis.

Port of ``paddlebox_tpu/parallel/pipeline.py`` (≙ the reference's two
pipeline engines: dygraph PipelineParallel 1F1B (meta_parallel/
pipeline_parallel.py:82, p2p send/recv :106-137) and the static-graph
SectionWorker schedules (section_worker.cc:149-213, GPipe-ish mode 0 /
1F1B mode 1), plus the PipelineLayer partitioner
(parallel_layers/pp_layers.py)).

The JAX package runs every stage in one SPMD program: a ``lax.scan``
over the schedule's ticks, with activations hopping stage → stage by
``ppermute``.  The port runs the same schedules tick by tick under one
controller: the stages are a topology's shards along ``pp`` (per-shard
lists, as everywhere in ``parallel/``), and a hop is ``ppermute``'s list
rotation.  A tick's work on a stage with no microbatch in it (the
schedule's bubble) is skipped; the JAX program computes it and masks it
out, adding exact zeros, so the sums are the same.

* :class:`PipelineRunner` (GPipe): the forward is differentiable, and
  torch's autograd through the tick loop is the backward pipeline.
* :class:`PipelineRunner1F1B` and :class:`HeteroPipeline1F1B` run their
  own backward: at tick t stage s forwards microbatch t − s and
  backwards t − (2·pp − 2 − s), recomputing its forward from the
  stashed INPUT (recompute-in-backward), and return (mean loss, grads).
  The stash holds at most 2·pp microbatch inputs, whatever the count of
  microbatches; per-stage gradients are accumulated in tick order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from paddlebox_tpu_torch.parallel import collective
from paddlebox_tpu_torch.parallel.topology import HybridTopology

Shards = List[torch.Tensor]


def _check_axis(topo: HybridTopology, axis: str, n_stages: int) -> None:
    if topo.axis_size(axis) != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis!r} axis of size "
                         f"{topo.axis_size(axis)}")


def _rotate(xs: list, topo: HybridTopology, axis: str, pp: int,
            shift: int) -> list:
    """Each stage's value moved to stage s + shift (mod pp) along the
    axis: ``ppermute`` as a list rotation."""
    return collective.ppermute(xs, topo, axis,
                               [(i, (i + shift) % pp) for i in range(pp)])


def _one_f_one_b(topo: HybridTopology, axis: str, pp: int, n_mb: int,
                 stage_params: Callable, fwd: Callable, feed: Callable,
                 loss_of: Callable):
    """The 1F1B schedule over every shard: M + 2·pp − 2 ticks.

    stage_params(k) -> shard k's differentiated params (a dict);
    fwd(k, params, x) -> y; feed(k, m) -> stage 0's input of microbatch
    m; loss_of(k, y, m) -> the last stage's loss of microbatch m.
    Returns (per-shard summed loss, per-shard summed grads, peak stash
    occupancy)."""
    world = topo.world_size
    pos = collective.axis_index(topo, axis)
    cap = 2 * pp
    params = [stage_params(k) for k in range(world)]
    y_send: list = [None] * world
    g_send: list = [None] * world
    stash = [[None] * cap for _ in range(world)]
    g_acc = [{n: torch.zeros_like(v) for n, v in p.items()} for p in params]
    loss_acc = [None] * world
    peak = 0
    for t in range(n_mb + 2 * pp - 2):
        x_in = _rotate(y_send, topo, axis, pp, 1)
        g_in = _rotate(g_send, topo, axis, pp, -1)
        for k in range(world):
            s = pos[k]
            m_f = t - s
            if 0 <= m_f < n_mb:
                x_f = feed(k, m_f) if s == 0 else x_in[k]
                with torch.no_grad():
                    y_send[k] = fwd(k, params[k], x_f)
                if stash[k][m_f % cap] is not None:
                    raise AssertionError(
                        f"1F1B stash slot {m_f % cap} of stage {s} is still "
                        f"in flight at tick {t}")
                stash[k][m_f % cap] = x_f
                peak = max(peak, sum(x is not None for x in stash[k]))
            m_b = t - (2 * pp - 2 - s)
            if not 0 <= m_b < n_mb:
                continue
            x_b, stash[k][m_b % cap] = stash[k][m_b % cap], None
            with torch.enable_grad():
                p = {n: v.detach().requires_grad_() for n, v in
                     params[k].items()}
                x = x_b.detach().requires_grad_(s > 0)
                y = fwd(k, p, x)
                wrt = [*p.values()] + ([x] if s > 0 else [])
                if s == pp - 1:
                    loss = loss_of(k, y, m_b)
                    grads = torch.autograd.grad(loss, wrt)
                    loss = loss.detach()
                    loss_acc[k] = (loss if loss_acc[k] is None
                                   else loss_acc[k] + loss)
                else:
                    grads = torch.autograd.grad(y, wrt, g_in[k])
            g_acc[k] = {n: a + d for (n, a), d in zip(g_acc[k].items(),
                                                      grads)}
            if s > 0:
                g_send[k] = grads[-1]
    return loss_acc, g_acc, peak


class PipelineRunner:
    """Run ``stage_fn`` (the same signature on every stage) as a pp-deep
    GPipe pipeline.

    stage_fn(stage_params, x) -> y, with x and y of one shape (the
    homogeneous-stage contract the reference's SegmentLayers also
    assumes)."""

    def __init__(self, stage_fn: Callable, n_stages: int, axis: str = "pp"):
        self.stage_fn = stage_fn
        self.n_stages = n_stages
        self.axis = axis

    def __call__(self, params_locals: List[Dict], microbatches: Shards,
                 topo: HybridTopology) -> Shards:
        """params_locals: each shard's stage params (leading [1, ...]
        stage dim, the blocks of a pp-split stack); microbatches: each
        shard's [M, Bm, ...] (replicated).  Returns each shard's
        [M, Bm, ...]: the last stage's outputs, replicated along the
        axis."""
        pp, axis = self.n_stages, self.axis
        _check_axis(topo, axis, pp)
        pos = collective.axis_index(topo, axis)
        n_mb = microbatches[0].shape[0]
        params = [{n: v[0] for n, v in p.items()} for p in params_locals]
        prev: list = [None] * topo.world_size
        last: Dict[int, list] = {}
        for t in range(n_mb + pp - 1):
            incoming = _rotate(prev, topo, axis, pp, 1)
            for k, s in enumerate(pos):
                if not 0 <= t - s < n_mb:
                    continue          # the bubble: no microbatch here
                x = microbatches[k][t] if s == 0 else incoming[k]
                prev[k] = self.stage_fn(params[k], x)
                if s == pp - 1:
                    last.setdefault(k, []).append(prev[k])
        out = [None] * topo.world_size
        for g in topo.axis_groups(axis):
            ys = torch.stack(last[g[pp - 1]])
            for k in g:
                out[k] = ys
        return out


class PipelineRunner1F1B:
    """1F1B schedule (≙ SectionWorker schedule_mode=1,
    section_worker.cc:149, and dygraph PipelineParallel.forward_backward_
    pipeline, pipeline_parallel.py:82): the activation stash is bounded
    by 2·pp microbatch inputs — constant in the microbatch count —
    unlike the autograd GPipe runner, which keeps every tick's graph.
    Not meant to be differentiated: it returns (mean loss, per-stage
    param grads)."""

    def __init__(self, stage_fn: Callable, loss_fn: Callable, n_stages: int,
                 axis: str = "pp"):
        self.stage_fn = stage_fn      # (stage_params, x) -> y, same shape
        self.loss_fn = loss_fn        # (y, target_mb) -> scalar (sum-able)
        self.n_stages = n_stages
        self.axis = axis
        self.peak_stash = 0

    @property
    def stash_slots(self) -> int:
        """In-flight activation bound: 2·pp microbatch inputs."""
        return 2 * self.n_stages

    def __call__(self, params_locals: List[Dict], microbatches: Shards,
                 targets: Shards, topo: HybridTopology):
        """params_locals: each shard's [1, ...] stage params block;
        microbatches [M, Bm, ...] and targets [M, ...] per shard
        (replicated).  Returns (per-shard mean loss over the
        microbatches, per-shard param grads [1, ...])."""
        pp, axis = self.n_stages, self.axis
        _check_axis(topo, axis, pp)
        n_mb = microbatches[0].shape[0]
        loss_acc, g_acc, self.peak_stash = _one_f_one_b(
            topo, axis, pp, n_mb,
            lambda k: {n: v[0] for n, v in params_locals[k].items()},
            lambda k, p, x: self.stage_fn(p, x),
            lambda k, m: microbatches[k][m],
            lambda k, y, m: self.loss_fn(y, targets[k][m]))
        losses = [None] * topo.world_size
        for g in topo.axis_groups(axis):
            for k in g:
                # the loss lives on the last stage; replicate it
                losses[k] = loss_acc[g[pp - 1]] / n_mb
        grads = [{n: (a / n_mb)[None] for n, a in acc.items()}
                 for acc in g_acc]
        return losses, grads


class HeteroPipeline1F1B:
    """1F1B over HETEROGENEOUS stages — per-stage functions, params and
    activation shapes (≙ SectionWorker's per-section programs +
    schedule_mode=1, section_worker.cc:149-213, where each section runs
    its own sub-program).

    The JAX package runs one program on every device, so it selects the
    stage body with ``lax.switch`` and carries activations in a flat pad
    buffer of one static size; here each stage runs its own function on
    its own shapes.  Params travel as a tuple of per-stage dicts
    (replicated); a shard differentiates only its stage's dict, and the
    full grad tuple is assembled from the stages (≙ the JAX package's
    one psum at the end).  The stash is bounded at 2·pp microbatch
    inputs (recompute-in-backward) — constant in M."""

    def __init__(self, stage_fns: Sequence[Callable],
                 io_shapes: Sequence[tuple], loss_fn: Callable,
                 axis: str = "pp"):
        """stage_fns[s](params_s, x_s) -> y_s; io_shapes is the chain
        [shape_0, shape_1, ..., shape_pp] with shape_s = stage s's input
        microbatch shape and shape_pp the final output shape."""
        self.stage_fns = list(stage_fns)
        self.io_shapes = [tuple(s) for s in io_shapes]
        self.loss_fn = loss_fn
        self.axis = axis
        self.n_stages = len(self.stage_fns)
        if len(self.io_shapes) != self.n_stages + 1:
            raise ValueError(f"{len(self.io_shapes)} io_shapes for "
                             f"{self.n_stages} stages (want stages + 1)")
        self.peak_stash = 0

    @property
    def stash_slots(self) -> int:
        """In-flight activation bound: 2·pp microbatch inputs,
        independent of M (the 1F1B memory contract vs GPipe's O(M))."""
        return 2 * self.n_stages

    def _stage(self, s: int, p: Dict, x: torch.Tensor) -> torch.Tensor:
        y = self.stage_fns[s](p, x)
        if tuple(y.shape) != self.io_shapes[s + 1]:
            raise ValueError(f"stage {s} gave {tuple(y.shape)}, io_shapes "
                             f"say {self.io_shapes[s + 1]}")
        return y

    def __call__(self, params_all: Sequence[Dict], microbatches: Shards,
                 targets: Shards, topo: HybridTopology):
        """params_all: the tuple of per-stage param dicts (replicated);
        microbatches [M, *io_shapes[0]] and targets [M, ...] per shard.
        Returns (per-shard mean loss, per-shard full grad tuple)."""
        pp, axis = self.n_stages, self.axis
        _check_axis(topo, axis, pp)
        if tuple(microbatches[0].shape[1:]) != self.io_shapes[0]:
            raise ValueError(f"microbatches of {tuple(microbatches[0].shape)}"
                             f", io_shapes[0] is {self.io_shapes[0]}")
        pos = collective.axis_index(topo, axis)
        n_mb = microbatches[0].shape[0]
        loss_acc, g_acc, self.peak_stash = _one_f_one_b(
            topo, axis, pp, n_mb,
            lambda k: params_all[pos[k]],
            lambda k, p, x: self._stage(pos[k], p, x),
            lambda k, m: microbatches[k][m],
            lambda k, y, m: self.loss_fn(y, targets[k][m]))
        losses, grads = [None] * topo.world_size, [None] * topo.world_size
        for g in topo.axis_groups(axis):
            # each stage's grads come from the shard that runs it
            full = tuple({n: a / n_mb for n, a in g_acc[g[i]].items()}
                         for i in range(pp))
            for k in g:
                losses[k] = loss_acc[g[pp - 1]] / n_mb
                grads[k] = full
        return losses, grads


def stack_stage_params(per_stage_params: Sequence[Dict]) -> Dict:
    """[pp] list of dicts of the same keys and shapes → one dict with a
    leading stage dim (split over pp with ``Spec("pp")``)."""
    return {n: torch.stack([p[n] for p in per_stage_params])
            for n in per_stage_params[0]}


def segment_layers(n_layers: int, n_stages: int) -> List[int]:
    """≙ SegmentLayers uniform partition (pp_layers.py): layer counts per
    stage, the remainder spread to the earliest stages."""
    base = n_layers // n_stages
    rem = n_layers % n_stages
    return [base + (1 if i < rem else 0) for i in range(n_stages)]
