"""The reference follows the first steps of a pass.

It trains batches 0 .. n - 1 of the records in order, from the dense
weights the benchmark drew and from fresh sparse rows it works out
itself, and records what the comparison reads: each step's loss, the
first step's gradients as the optimizers receive them, and the state
after the last step.  The loss is the mean binary cross-entropy of the
logits over the batch; the dense optimizer is Adam (PyTorch's update:
bias-corrected moments, eps added after the square root).

``tf32=True`` runs every float32 matrix product in TF32: the control,
one precision below the configuration's.  Faults the comparison must
catch: ``half_batch=True`` leaves the second half of every batch out and
takes the mean over the rest; ``lost_push`` names a merged push field
(``g_embed`` or ``g_embedx``) that is zeroed before the sparse rule, as
a push that loses the lr weight's or the embedx gradient would.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict

import numpy as np
import torch

from portbench.reference import sparse


def model_module(name: str):
    return importlib.import_module(f"portbench.reference.models.{name}")


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """Set both of PyTorch's TF32 switches for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def batch_occurrences(records, i: int, keys: np.ndarray, device,
                      keep: int = 0):
    """Batch ``i`` as occurrences: each key's row in ``keys``, its
    (record, slot) segment ``record * S + slot``, label and slot id.
    ``keep``: only the first ``keep`` records (0: all)."""
    slots, labels, dense = records.batch(i)
    b = len(labels) if not keep else keep
    n_slots = len(slots)
    rows, segs, slot_col = [], [], []
    for s, (k, lens) in enumerate(slots):
        lens = lens[:b]
        k = k[:int(lens.sum())]
        rows.append(np.searchsorted(keys, k))
        segs.append(np.repeat(np.arange(b, dtype=np.int64) * n_slots + s,
                              lens))
        slot_col.append(np.full(len(k), records.slot_ids[s], np.int32))
    rec = np.concatenate(segs) // n_slots
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return {"row": as_t(np.concatenate(rows), torch.int64),
            "seg": as_t(np.concatenate(segs), torch.int64),
            "label": as_t(labels[:b][rec], torch.float32),
            "slot": as_t(np.concatenate(slot_col), torch.int32),
            "labels": as_t(labels[:b], torch.float32),
            "dense": as_t(dense[:b], torch.float32), "b": b,
            "n_slots": n_slots}


def follow(records, cfg: Dict, init: Dict[str, torch.Tensor],
           table_seed: int, n_steps: int = 3, device="cpu",
           tf32: bool = False, half_batch: bool = False,
           lost_push: str = "") -> Dict:
    """Train the first ``n_steps`` batches; returns the trajectory
    (``losses``, ``grad1`` by leaf, ``params`` and ``sparse`` after the
    last step, the sparse rows' ``keys`` and their ``fresh`` values)."""
    dev = torch.device(device)
    mod = model_module(cfg["model"])
    sgd = cfg["sparse_sgd"]
    keys = np.unique(np.concatenate(
        [np.concatenate([k for k, _ in records.batch(i)[0]])
         for i in range(n_steps)]))
    table = sparse.fresh_rows(keys, cfg["embedding_dim"], table_seed, sgd,
                              dev)
    fresh = {f: v.clone() for f, v in table.items()}
    params = {k: v.detach().clone().to(dev) for k, v in init.items()}
    adam = Adam(params, cfg["dense_optimizer"]["lr"])
    losses, grad1 = [], None
    keep = records.batch_size // 2 if half_batch else 0
    with matmul_tf32(tf32):
        for i in range(n_steps):
            occ = batch_occurrences(records, i, keys, dev, keep)
            b, n_slots = occ["b"], occ["n_slots"]
            pooled = sparse.pull_pool_cvm(table, occ["row"], occ["seg"],
                                          b * n_slots)
            pooled = pooled.reshape(b, n_slots, -1).requires_grad_(True)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            logit = mod.logits(leaves, pooled, occ["dense"], cfg)
            loss = torch.nn.functional.binary_cross_entropy_with_logits(
                logit, occ["labels"])
            got = torch.autograd.grad(loss, [pooled] + list(leaves.values()))
            d_pooled = got[0].reshape(b * n_slots, -1)
            grads = dict(zip(leaves, got[1:]))
            for v in params.values():
                v.requires_grad_(False)
            adam.step(params, grads)
            acc = sparse.merged_push(len(keys), occ["row"], occ["seg"],
                                     occ["label"], occ["slot"], d_pooled)
            if lost_push:
                acc[lost_push] = torch.zeros_like(acc[lost_push])
            if i == 0:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
                scale = torch.where(acc["g_show"] > 0, acc["g_show"],
                                    torch.ones_like(acc["g_show"]))
                grad1["embed_w"] = acc["g_embed"] / scale
            sparse.adagrad(table, acc, sgd)
            losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "params": params,
            "sparse": table, "keys": keys, "fresh": fresh}
